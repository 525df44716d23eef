"""Elementwise ops of the PyTorch port against the JAX package: threshold,
indicator, signed merge, byte remap, and refined_sqrt bit for bit over every
integer radicand below 2^24. Inputs come from numpy and go to both sides;
every comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import merge as jmerge
from chaq_sdfgen_tpu.ops import numerics as jnum
from chaq_sdfgen_tpu.ops import threshold as jthr
from chaq_sdfgen_tpu_torch.ops import merge as tmerge
from chaq_sdfgen_tpu_torch.ops import numerics as tnum
from chaq_sdfgen_tpu_torch.ops import threshold as tthr


@pytest.mark.parametrize("channel", [0, 1])
@pytest.mark.parametrize("test_above", [True, False])
def test_hard_threshold_matches(channel, test_above):
    rng = np.random.default_rng(10 + channel)
    img = rng.integers(0, 256, size=(3, 21, 30, 2), dtype=np.uint8)
    img[0, 0, :4, channel] = [126, 127, 128, 255]
    want = np.asarray(jthr.hard_threshold(jnp.asarray(img), channel, test_above))
    got = tthr.hard_threshold(torch.from_numpy(img), channel, test_above).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.bool_


@pytest.mark.parametrize("true_is_zero", [True, False])
def test_indicator_matches(true_is_zero):
    b = np.random.default_rng(11).random((17, 23)) < 0.4
    want = np.asarray(jthr.indicator(jnp.asarray(b), true_is_zero, 4489.0))
    got = tthr.indicator(torch.from_numpy(b), true_is_zero, 4489.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32


def _field_values(spread, seed):
    """Signed-field values as the pipeline makes them: sqrt'ed integers,
    raw integers, and the extremes around the clamp."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, (spread + 3) ** 2, size=4000).astype(np.float32)
    roots = np.asarray(jnum.refined_sqrt(jnp.asarray(ints)))
    edge = np.array([0, 0.5, 1, spread - 1, spread, spread + 1, 1e9], np.float32)
    return np.concatenate([roots, ints[:500], edge, -edge]).astype(np.float32)


@pytest.mark.parametrize("spread", [1, 64, 100, 300])
@pytest.mark.parametrize("asymmetric", [False, True])
def test_signed_merge_and_remap_match(spread, asymmetric):
    outside = _field_values(spread, spread)
    inside = np.random.default_rng(spread + 1).permutation(_field_values(spread, spread + 2))
    jm = jmerge.signed_merge(jnp.asarray(outside), jnp.asarray(inside))
    tm = tmerge.signed_merge(torch.from_numpy(outside), torch.from_numpy(inside))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = np.asarray(jmerge.remap_to_byte(jm, spread, asymmetric))
    got = tmerge.remap_to_byte(tm, spread, asymmetric).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8


def test_refined_sqrt_bitwise_all_2_24_integers():
    n = np.arange(1 << 24, dtype=np.float32)
    want = np.asarray(jnum.refined_sqrt(jnp.asarray(n))).view(np.uint32)
    got = tnum.refined_sqrt(torch.from_numpy(n)).numpy().view(np.uint32)
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, f"{bad.size} mismatches, first radicands {bad[:5]}"


def test_refined_sqrt_correctly_rounded_where_cpu_sqrt_is_not():
    """Why refined_sqrt exists: the CPU torch.sqrt can be off by one ulp
    on integer radicands (267, 999 and 1068 are the first three measured).
    refined_sqrt matches numpy's correctly rounded sqrt there."""
    n = torch.tensor([267.0, 999.0, 1068.0])
    want = np.sqrt(n.numpy())
    np.testing.assert_array_equal(tnum.refined_sqrt(n).numpy(), want)
