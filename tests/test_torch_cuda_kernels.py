"""The hard path's CUDA kernels (csrc/edt.cu) against their plain PyTorch
versions on the card, byte for byte. Marked ``gpu``: each test skips where
no CUDA device is present. This file imports no JAX, so on a machine
without it run it past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.config import SdfConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
from chaq_sdfgen_tpu_torch.ops import cuda_edt
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _codes(shape, seed, tri_state=False, density=0.3):
    rng = np.random.default_rng(seed)
    if tri_state:
        return torch.from_numpy(rng.integers(0, 3, size=shape, dtype=np.uint8))
    return torch.from_numpy(rng.random(shape) < density)


SHAPES = [(1, 17), (17, 1), (139, 131), (3, 32, 32), (300, 1100)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("band", [3, 66, 302])
@pytest.mark.parametrize("tri_state", [False, True])
def test_edt_rows_matches_plain(dev, shape, band, tri_state):
    codes = _codes(shape, band, tri_state, density=0.05).to(dev)
    before = cuda_edt.LAUNCHES["edt_rows"]
    din, dout = cuda_edt.row_distances_u8(codes, band)
    assert cuda_edt.LAUNCHES["edt_rows"] == before + 1
    pin, pout = cuda_edt.row_distances_u8_plain(codes, band)
    torch.cuda.synchronize()
    assert din.dtype == pin.dtype == cuda_edt.strip_dtype(band)
    assert torch.equal(din, pin) and torch.equal(dout, pout)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spread,asymmetric", [(1, False), (64, False), (64, True), (300, False)])
def test_edt_band_bytes_matches_plain(dev, shape, spread, asymmetric):
    band = spread + 2
    din, dout = cuda_edt.row_distances_u8_plain(_codes(shape, spread, density=0.05).to(dev), band)
    apply_sqrt = shape[-2] > 1
    before = cuda_edt.LAUNCHES["edt_band_bytes"]
    got = cuda_edt.fused_pass2_bytes(din, dout, spread, asymmetric, band, apply_sqrt)
    assert cuda_edt.LAUNCHES["edt_band_bytes"] == before + 1
    want = cuda_edt.fused_pass2_bytes_plain(din, dout, spread, asymmetric, band, apply_sqrt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("apply_sqrt", [True, False])
def test_edt_band_bytes_random_strips(dev, apply_sqrt):
    """Strips that are not row distances at all: pass 2 is defined on any."""
    rng = np.random.default_rng(7)
    din = torch.from_numpy(rng.integers(0, 256, size=(2, 77, 93), dtype=np.uint8)).to(dev)
    dout = torch.from_numpy(rng.integers(0, 256, size=(2, 77, 93), dtype=np.uint8)).to(dev)
    got = cuda_edt.fused_pass2_bytes(din, dout, 40, False, 42, apply_sqrt)
    want = cuda_edt.fused_pass2_bytes_plain(din, dout, 40, False, 42, apply_sqrt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("spread", [8, 1024])
def test_fused_sdf_bytes_uniform_masks(dev, fill, spread):
    b = torch.full((40, 70), fill, device=dev)
    assert torch.equal(cuda_edt.fused_sdf_bytes(b, spread), cuda_edt.fused_sdf_bytes_plain(b, spread))


def test_refined_sqrt_tail_all_2_24_integers(dev):
    n = torch.arange(1 << 24, dtype=torch.float32, device=dev)
    got = cuda_edt.refined_sqrt_cuda(n).view(torch.int32)
    want = refined_sqrt(n).view(torch.int32)
    assert int((got != want).sum()) == 0


def test_sdf_generator_runs_both_kernels(dev):
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (96, 80, 2), dtype=np.uint8))
    gen = SDFGenerator(SdfConfig(spread=12), device=dev)
    before = dict(cuda_edt.LAUNCHES)
    out = gen.generate(img)
    assert cuda_edt.LAUNCHES["edt_rows"] == before["edt_rows"] + 1
    assert cuda_edt.LAUNCHES["edt_band_bytes"] == before["edt_band_bytes"] + 1
    want = SDFGenerator(SdfConfig(spread=12), device="cpu").generate(img)
    assert torch.equal(out.cpu(), want)
    assert gen.kernel_time(img, iters=3) > 0


def test_wrappers_refuse_what_kernels_do_not_take(dev):
    b = torch.zeros((8, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        cuda_edt.row_distances_u8(b.to(torch.uint8).t(), 5)  # not contiguous
    din, dout = cuda_edt.row_distances_u8(b, 5)
    with pytest.raises(ValueError):
        cuda_edt.fused_pass2_bytes(din, dout.cpu(), 3, False, 5)
    with pytest.raises(ValueError):
        cuda_edt.fused_pass2_bytes(din, dout[:4], 3, False, 5)
    with pytest.raises(TypeError):
        cuda_edt.fused_pass2_bytes(din.float(), dout.float(), 3, False, 5)
