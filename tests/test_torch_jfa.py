"""The port's jump flood (JFA) on the CPU against the JAX package: the
state (sy, sx, d2, valid) bitwise, the distance field's float32 bits, and
the JFA pipeline's bytes. Each case is one input."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chaq_sdfgen_tpu.models import sdf_model as jmodel
from chaq_sdfgen_tpu.ops import jfa as jjfa

from chaq_sdfgen_tpu_torch.models import sdf_model as tmodel
from chaq_sdfgen_tpu_torch.ops import jfa as tjfa

CASES = [
    # (shape, density, plus_one); few distinct (shape, plus_one), as each compiles JAX's side once
    ((64, 48), 0.001, True),
    ((64, 48), 0.02, True),
    ((64, 48), 0.3, True),
    ((64, 48), 0.0, True),
    ((37, 53), 0.02, False),
    ((37, 53), 0.3, False),
    ((1, 29), 0.1, True),
    ((31, 1), 0.1, False),
    ((2, 17, 23), 0.05, True),
]


# jitted here only for speed (integer ops: the same values as op by op)
_jax_seed_coords = jax.jit(jjfa.jfa_seed_coords, static_argnames=("plus_one",))


def _seeds(shape, density, seed=0):
    b = np.random.default_rng(seed + int(1000 * density)).random(shape) < density
    return b


@pytest.mark.parametrize("shape,density,plus_one", CASES)
def test_jfa_seed_coords_bitwise_jax(shape, density, plus_one):
    b = _seeds(shape, density)
    if density == 0.001:
        b[0, 0] = True  # one far seed: the flood must carry it across the image
    want = _jax_seed_coords(jnp.asarray(b), plus_one=plus_one)
    got = tjfa.jfa_seed_coords(torch.from_numpy(b), plus_one=plus_one)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.bool


@pytest.mark.parametrize("shape,density,plus_one", CASES)
def test_jfa_distance_bits_equal_jax(shape, density, plus_one):
    b = _seeds(shape, density, seed=1)
    want = np.asarray(jjfa.jfa_distance(jnp.asarray(b), plus_one=plus_one))
    got = tjfa.jfa_distance(torch.from_numpy(b), plus_one=plus_one).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if density == 0.0:
        assert (got == 32768.0).all()


@pytest.mark.parametrize("h,w,plus_one", [(1, 1, True), (1, 2, True), (5, 3, False), (64, 48, True),
                                          (65, 9, False), (4097, 3, True)])
def test_stride_schedule_matches_jax(h, w, plus_one):
    assert tjfa.strides(h, w, plus_one) == jjfa._strides(h, w, plus_one)


@pytest.mark.parametrize(
    "spread,asymmetric,channel,test_above,plus_one",
    [(12, False, 1, True, True), (20, True, 0, True, True), (7, False, 1, False, False), (64, False, 1, True, True)],
)
def test_hard_sdf_jfa_bytes_match_jax(spread, asymmetric, channel, test_above, plus_one):
    rng = np.random.default_rng(spread)
    img2ch = rng.integers(0, 256, size=(56, 61, 2), dtype=np.uint8)
    img2ch[..., channel] = np.where(rng.random((56, 61)) < 0.3, 220, 20)
    kw = dict(spread=spread, asymmetric=asymmetric, channel=channel, test_above=test_above, plus_one=plus_one)
    got = tmodel.hard_sdf_jfa(torch.from_numpy(img2ch), **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmodel.hard_sdf_jfa(jnp.asarray(img2ch), **kw)))
