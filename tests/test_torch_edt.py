"""The port's plain banded EDT (chaq_sdfgen_tpu_torch/ops/edt.py) against
the JAX package's (chaq_sdfgen_tpu/ops/edt.py): same inputs from numpy,
exact equality. Covers odd shapes, single rows and columns (the reference's
no-sqrt quirk), uniform masks and a batch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import edt as jedt
from chaq_sdfgen_tpu_torch.ops import edt as tedt

SHAPES = [(1, 1), (1, 17), (17, 1), (5, 64), (33, 47), (2, 9, 13)]


def _mask(shape, seed, density=0.3):
    return np.random.default_rng(seed).random(shape) < density


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("band", [3, 10, 66])
def test_row_nearest_sq_matches(shape, band):
    b = _mask(shape, band)
    want = np.asarray(jedt.row_nearest_sq(jnp.asarray(b), band))
    got = tedt.row_nearest_sq(torch.from_numpy(b), band).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


@pytest.mark.parametrize("band", [1, 4, 9])
def test_band_min_ext_matches(band):
    rng = np.random.default_rng(band)
    gext = rng.integers(0, (band + 1) ** 2 + 1, size=(2, 19 + 2 * band, 11)).astype(np.float32)
    want = np.asarray(jedt.band_min_ext(jnp.asarray(gext), band))
    got = tedt.band_min_ext(torch.from_numpy(gext), band).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("band", [3, 10])
def test_dual_edt_banded_matches(shape, band):
    b = _mask(shape, 100 + band)
    jin, jout = jedt.dual_edt_banded(jnp.asarray(b), band)
    tin, tout = tedt.dual_edt_banded(torch.from_numpy(b), band)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("fill", [False, True])
def test_dual_edt_banded_uniform_masks(fill):
    b = np.full((12, 9), fill)
    jin, jout = jedt.dual_edt_banded(jnp.asarray(b), 9)
    tin, tout = tedt.dual_edt_banded(torch.from_numpy(b), 9)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


def test_big_sentinel_matches():
    for band in (1, 66, 1026):
        assert tedt.big_sentinel(band) == jedt.big_sentinel(band)
