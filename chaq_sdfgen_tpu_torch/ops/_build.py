"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

The sources are compiled into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), named after a hash of the
sources and flags, under ``build/kernels/`` at the repository root. The
build happens at first use; later calls in the process reuse the loaded
library, and later processes reuse the file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

# sm_90a: Hopper. No --use_fast_math: the kernels need IEEE sqrt and
# division (they also spell them as _rn intrinsics).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# what the last build in this process did: seconds, library path, and
# nvcc's stderr (ptxas register and spill counts)
BUILD_INFO: dict = {}


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libchaq_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        BUILD_INFO.update(seconds=0.0, path=out, log="(cached)")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=out, log=res.stderr)
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chaq_edt_rows.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
        lib.chaq_edt_rows.restype = i32
        lib.chaq_edt_band_bytes.argtypes = [
            vp, vp, vp, i32, i32, i32, i32, ctypes.c_float, ctypes.c_float, i32, i32, vp,
        ]
        lib.chaq_edt_band_bytes.restype = i32
        lib.chaq_refined_sqrt_f32.argtypes = [vp, vp, ctypes.c_longlong, vp]
        lib.chaq_refined_sqrt_f32.restype = i32
        _lib = lib
        return _lib
