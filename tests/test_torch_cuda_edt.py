"""The module that holds the hard path's kernels (ops/cuda_edt.py), on the
CPU, where its wrappers run the plain versions: held byte for byte against
the JAX package's Pallas kernels in interpret mode (pallas_edt.py), at
small shapes. The kernels themselves are checked against these plain
versions on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import pallas_edt
from chaq_sdfgen_tpu_torch.ops import cuda_edt


def _mask(shape, seed, density=0.3):
    return np.random.default_rng(seed).random(shape) < density


@pytest.mark.parametrize("shape", [(40, 140), (139, 131), (17, 1), (1, 17)])
@pytest.mark.parametrize("tri_state", [False, True])
def test_row_distances_u8_plain_matches_pallas(shape, tri_state):
    rng = np.random.default_rng(shape[0] * 7 + tri_state)
    if tri_state:
        codes = rng.integers(0, 3, size=shape, dtype=np.uint8)  # 2 seeds neither
        codes[: shape[0] // 2] = np.where(codes[: shape[0] // 2] == 1, 1, 2)
    else:
        codes = rng.random(shape) < 0.1
    band = 66
    jin, jout = pallas_edt.row_distances_u8(jnp.asarray(codes), band, interpret=True)
    tin, tout = cuda_edt.row_distances_u8(torch.from_numpy(codes), band)
    assert tin.dtype == torch.uint8 and tin.shape == shape
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_row_distances_u16_plain_matches_pallas_ext():
    b = _mask((24, 300), 5, density=0.01)
    band = 300
    jin, jout, off = pallas_edt.row_distances_u8_ext(
        jnp.asarray(b), band, interpret=True, dtype=jnp.uint16
    )
    tin, tout = cuda_edt.row_distances_u8(torch.from_numpy(b), band)
    assert tin.dtype == torch.uint16
    h, w = b.shape
    np.testing.assert_array_equal(tin.to(torch.int32).numpy(), np.asarray(jin)[off : off + h, :w])
    np.testing.assert_array_equal(tout.to(torch.int32).numpy(), np.asarray(jout)[off : off + h, :w])


@pytest.mark.parametrize("spread,asymmetric", [(8, False), (13, True), (64, False)])
def test_fused_pass2_bytes_plain_matches_pallas_halo(spread, asymmetric):
    band = spread + 2
    rng = np.random.default_rng(spread)
    h, w = 64, 40
    din = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
    dout = np.where(rng.random((h, w)) < 0.5, 0, rng.integers(0, 256, size=(h, w))).astype(np.uint8)
    hr = -(-(band + 8) // 8) * 8
    halo = jnp.full((hr, w), 255, jnp.uint8)
    want = pallas_edt.fused_pass2_bytes_halo(
        jnp.asarray(din), jnp.asarray(dout), halo, halo, halo, halo,
        spread, asymmetric, band, interpret=True,
    )
    got = cuda_edt.fused_pass2_bytes(torch.from_numpy(din), torch.from_numpy(dout), spread, asymmetric, band)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_pass2_bytes_plain_u16_matches_pallas():
    spread, band = 300, 302
    rng = np.random.default_rng(1)
    h, w = 48, 24
    din = rng.integers(0, 400, size=(h, w)).astype(np.uint16)
    dout = rng.integers(0, 400, size=(h, w)).astype(np.uint16)
    pad = np.full((band, w), 65535, np.uint16)
    want = pallas_edt.fused_pass2_bytes(
        jnp.asarray(np.concatenate([pad, din, pad])),
        jnp.asarray(np.concatenate([pad, dout, pad])),
        spread, False, band, interpret=True,
    )
    got = cuda_edt.fused_pass2_bytes(torch.from_numpy(din), torch.from_numpy(dout), spread, False, band)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


CASES = [
    # (shape, spread, asymmetric, density)
    ((64, 48), 8, False, 0.3),
    ((40, 140), 5, False, 0.3),
    ((139, 131), 13, False, 0.3),
    ((139, 131), 13, True, 0.3),
    ((1, 17), 8, False, 0.3),
    ((17, 1), 8, False, 0.3),
    ((256, 256), 64, False, 0.3),
    ((256, 250), 300, False, 0.02),   # u16 strips
    ((256, 250), 1024, False, 0.02),  # u16 strips
    ((256, 250), 300, True, 0.02),
    ((64, 80), 638, False, 0.02),     # band a multiple of 128
    ((3, 32, 32), 5, False, 0.3),     # leading batch dimension
]


@pytest.mark.parametrize("shape,spread,asymmetric,density", CASES)
def test_fused_sdf_bytes_matches_pallas(shape, spread, asymmetric, density):
    b = _mask(shape, spread + len(shape), density)
    want = pallas_edt.fused_sdf_bytes(jnp.asarray(b), spread, asymmetric, interpret=True)
    got = cuda_edt.fused_sdf_bytes(torch.from_numpy(b), spread, asymmetric)
    assert got.dtype == torch.uint8 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fill", [False, True])
def test_fused_sdf_bytes_uniform_masks(fill):
    b = np.full((24, 40), fill)
    want = pallas_edt.fused_sdf_bytes(jnp.asarray(b), 8, interpret=True)
    got = cuda_edt.fused_sdf_bytes(torch.from_numpy(b), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_sdf_bytes_canonicalizes_masks():
    """A 0/255 uint8 mask means the same as its bool mask: it never reaches
    pass 1 as tri-state codes (where 255 would seed neither field)."""
    b = _mask((21, 34), 8)
    want = cuda_edt.fused_sdf_bytes(torch.from_numpy(b), 6)
    as255 = torch.from_numpy(np.where(b, 255, 0).astype(np.uint8))
    np.testing.assert_array_equal(cuda_edt.fused_sdf_bytes(as255, 6).numpy(), want.numpy())
    np.testing.assert_array_equal(cuda_edt.fused_sdf_bytes_plain(as255, 6).numpy(), want.numpy())


def test_plain_pipeline_equals_wrapper_pipeline_on_cpu():
    b = torch.from_numpy(_mask((30, 20), 3))
    torch.testing.assert_close(cuda_edt.fused_sdf_bytes(b, 6), cuda_edt.fused_sdf_bytes_plain(b, 6), rtol=0, atol=0)


def test_cpu_tensors_do_not_launch():
    before = dict(cuda_edt.LAUNCHES)
    cuda_edt.fused_sdf_bytes(torch.from_numpy(_mask((9, 9), 4)), 3)
    assert cuda_edt.LAUNCHES == before


def test_band_beyond_u16_raises():
    b = torch.zeros((4, 4), dtype=torch.bool)
    with pytest.raises(ValueError):
        cuda_edt.fused_sdf_bytes(b, 65533)  # band 65535: band + 1 does not fit u16
    assert cuda_edt.strip_dtype(254) == torch.uint8  # band + 1 = 255 still fits
    assert cuda_edt.strip_dtype(255) == torch.uint16


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        cuda_edt.row_distances_u8(torch.zeros((4, 4), dtype=torch.float32), 3)
    with pytest.raises(TypeError):
        cuda_edt.row_distances_u8(torch.zeros((4, 4), dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        cuda_edt.refined_sqrt_cuda(torch.zeros(4))
