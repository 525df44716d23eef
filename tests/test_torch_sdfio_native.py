"""The port's native codec binding builds safely between processes: several
processes that find no library and load it at once all load a whole one
(chaq_sdfgen_tpu_torch/utils/sdfio_native.py: flock, temporary build,
os.replace). Each process builds into the same fresh directory."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
import numpy as np
from chaq_sdfgen_tpu_torch.utils import sdfio_native as n
n._SO_PATH = sys.argv[1]
assert n.available(), "no library"
img = np.arange(12 * 7, dtype=np.uint8).reshape(12, 7)
png = n.encode_gray(img, "png")
out = n.decode_gray_alpha(png)
assert out is not None and (out[..., 0] == img).all()
print("ok")
"""


@pytest.mark.parametrize("n_procs", [6])
def test_concurrent_first_loads_all_succeed(tmp_path, n_procs):
    so = str(tmp_path / "build" / "libsdfio.so")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, so], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(n_procs)]
    results = [p.communicate(timeout=240) + (p.returncode,) for p in procs]
    for out, err, rc in results:
        assert rc == 0 and out.strip() == "ok", err[-2000:]
    # one library, no temporary build directory left behind
    left = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert left == ["libsdfio.lock", "libsdfio.so"], left


def test_existing_library_is_loaded_without_a_build(tmp_path):
    """A later process finds the library and loads it as it is."""
    so = tmp_path / "libsdfio.so"
    stamps = []
    for _ in range(2):
        res = subprocess.run([sys.executable, "-c", _CHILD, str(so)], cwd=ROOT, capture_output=True,
                             text=True, timeout=240)
        assert res.returncode == 0, res.stderr[-2000:]
        stamps.append(so.stat().st_mtime_ns)
    assert stamps[0] == stamps[1]
