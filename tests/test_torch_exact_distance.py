"""The port's exact full-range distance field on the CPU: the plain
version of kernel edt_dist against the JAX Pallas kernel in interpret mode
(float32 bits equal), the saturation tiers, the no-seed value, a tall
two-seed image against NumPy brute force, the JFA dispatch beyond 16384 px
per side, and signed_distance_field_exact against JAX's. Each case is one
input."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chaq_sdfgen_tpu.models import sdf_model as jmodel
from chaq_sdfgen_tpu.ops import pallas_edt as jpe

from chaq_sdfgen_tpu_torch.models import sdf_model as tmodel
from chaq_sdfgen_tpu_torch.ops import cuda_edt, jfa


def _mask(shape, density, seed):
    return np.random.default_rng(seed).random(shape) < density


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.int32)


def _brute_force(b):
    """float32 distance to the nearest TRUE pixel by NumPy brute force (an
    IEEE, correctly rounded sqrt of an exact integer below 2^24)."""
    ys, xs = np.nonzero(b)
    yy, xx = np.mgrid[0 : b.shape[0], 0 : b.shape[1]]
    d2 = np.min((yy[..., None] - ys) ** 2 + (xx[..., None] - xs) ** 2, axis=-1)
    return np.sqrt(d2.astype(np.float32))


CASES = [
    # (shape, density); at most 64 x 64, as interpret mode is slow
    ((64, 56), 0.05),
    ((64, 64), 0.02),
    ((61, 37), 0.3),
    ((48, 64), 0.004),
    ((1, 50), 0.1),
    ((45, 1), 0.1),
    ((40, 64), 0.0),
]


@pytest.mark.parametrize("shape,density", CASES)
def test_exact_distance_field_bits_equal_jax_pallas(shape, density):
    b = _mask(shape, density, shape[0] * shape[1])
    want = jpe.exact_distance_field(jnp.asarray(b), interpret=True)
    got = cuda_edt.exact_distance_field(torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if density == 0.0:
        assert (got == cuda_edt.NO_SEED).all()


def test_one_far_seed_worst_case_matches_jax_pallas():
    b = np.zeros((64, 56), bool)
    b[0, 0] = True
    got = cuda_edt.exact_distance_field(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jpe.exact_distance_field(jnp.asarray(b), interpret=True)))
    np.testing.assert_array_equal(_bits(got), _bits(_brute_force(b)))


@pytest.mark.parametrize("n,sat", [(1, 8191), (4096, 8191), (4097, 16383), (8192, 16383), (8193, 23170),
                                   (16384, 23170), (16385, None)])
def test_dist_sat_tiers_match_jax(n, sat):
    assert cuda_edt.dist_sat(n) == jpe._dist_sat(n) == sat
    if sat is not None:
        assert sat * sat > 2 * (n - 1) ** 2 and sat * sat + (n - 1) ** 2 < 2**31


def test_tall_two_seed_image_matches_bruteforce():
    """The 4104 x 128 case of tests/test_jfa.py (tier 16383), against NumPy
    brute force: interpret mode is too slow at this size."""
    b = np.zeros((4104, 128), bool)
    b[2, 5] = True
    b[4100, 100] = True
    assert cuda_edt.dist_sat(4104) == 16383
    got = cuda_edt.exact_distance_field(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_brute_force(b)))


@pytest.mark.parametrize("shape", [(1, 16385), (16385, 2)])
def test_beyond_16384_px_per_side_is_jfa(shape):
    b = np.zeros(shape, bool)
    b.flat[[3, b.size // 2]] = True
    got = cuda_edt.exact_distance_field(torch.from_numpy(b))
    assert torch.equal(got, jfa.jfa_distance(torch.from_numpy(b)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(_brute_force(b)))


def test_batch_matches_per_image():
    b = torch.from_numpy(_mask((3, 40, 30), 0.03, 3))
    got = cuda_edt.exact_distance_field(b)
    for i in range(3):
        assert torch.equal(got[i], cuda_edt.exact_distance_field(b[i]))


@pytest.mark.parametrize("shape,density", [((64, 48), 0.3), ((64, 64), 0.02), ((2, 33, 40), 0.2),
                                           ((40, 40), 0.0), ((40, 40), 1.0)])
def test_signed_distance_field_exact_matches_jax(shape, density):
    """One pass 1 for both polarities (the port) against JAX's two runs."""
    b = _mask(shape, density, 7)
    want = np.asarray(jmodel.signed_distance_field_exact(jnp.asarray(b), interpret=True))
    got = tmodel.signed_distance_field_exact(torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_fields_from_one_pass_equal_two_runs():
    b = torch.from_numpy(_mask((50, 70), 0.1, 11))
    d_in, d_out = cuda_edt.exact_distance_fields(b)
    assert torch.equal(d_in, cuda_edt.exact_distance_field(b))
    assert torch.equal(d_out, cuda_edt.exact_distance_field(torch.logical_not(b)))
    assert all(torch.equal(a, p) for a, p in zip((d_in, d_out), cuda_edt.exact_distance_fields_plain(b)))
