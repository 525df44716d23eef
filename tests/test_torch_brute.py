"""The port's BRUTE pipeline (OpenCL-binary parity) on the CPU, against the
JAX package (its XLA scan and its Pallas kernels in interpret mode) and the
NumPy oracle of the reference kernel (sdfref), with tolerance 0: integers
and bytes equal. Each case is one input."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chaq_sdfgen_tpu.models import sdf_model as jmodel
from chaq_sdfgen_tpu.ops import brute as jbrute
from chaq_sdfgen_tpu.ops import pallas_brute as jpb
from sdfref import oracle

from chaq_sdfgen_tpu_torch.models import sdf_model as tmodel
from chaq_sdfgen_tpu_torch.ops import brute as tbrute
from chaq_sdfgen_tpu_torch.ops import cuda_brute


def _mask(shape, density, seed):
    return np.random.default_rng(seed).random(shape) < density


def _img(b):
    """The gray+alpha image of test_brute_parity.py: alpha 255/0, gray 230/30."""
    img2ch = np.zeros(b.shape + (2,), dtype=np.uint8)
    img2ch[..., 1] = np.where(b, 255, 0)
    img2ch[..., 0] = np.where(b, 230, 30)
    return img2ch


def _xla(b, spread, asymmetric=False, invert=False):
    return np.asarray(jbrute.brute_sdf_bytes(jnp.asarray(b), spread, asymmetric, invert, use_pallas=False))


def _port(b, spread, asymmetric=False, invert=False):
    out = cuda_brute.brute_sdf_bytes(torch.from_numpy(np.ascontiguousarray(b)), spread, asymmetric, invert)
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize(
    "shape,density,sentinel",
    [((1, 8), 0.25, 9), ((5, 40), 0.1, 7), ((3, 64), 0.5, 300), ((4, 33), 0.0, 5), ((2, 17), 1.0, 4),
     ((6, 50), 0.03, 255)],
)
def test_row_seed_distances_match_jax(shape, density, sentinel):
    seeds = _mask(shape, density, sentinel)
    want = jbrute.row_seed_distances(jnp.asarray(seeds), sentinel)
    got = tbrute.row_seed_distances(torch.from_numpy(seeds), sentinel)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_row_seed_distances_reference_values():
    seeds = torch.tensor([[0, 1, 0, 0, 1, 0, 0, 0]], dtype=torch.bool)
    l1, l2, r1, r2 = [x[0].tolist() for x in tbrute.row_seed_distances(seeds, 9)]
    assert l1 == [9, 0, 1, 2, 0, 1, 2, 3] and l2 == [9, 9, 9, 9, 3, 4, 5, 6]
    assert r1 == [1, 0, 2, 1, 0, 9, 9, 9] and r2 == [4, 3, 9, 9, 9, 9, 9, 9]


@pytest.mark.parametrize(
    "shape,density,spread,asymmetric,invert",
    [((40, 56), 0.35, 9, False, False), ((33, 41), 0.35, 7, True, True), ((64, 30), 0.1, 17, False, True),
     ((16, 16), 0.35, 20, False, False), ((50, 37), 0.02, 12, True, False), ((29, 31), 0.6, 1, False, False)],
)
def test_brute_sdf_bytes_matches_jax_xla(shape, density, spread, asymmetric, invert):
    b = _mask(shape, density, spread)
    np.testing.assert_array_equal(_port(b, spread, asymmetric, invert), _xla(b, spread, asymmetric, invert))


@pytest.mark.parametrize(
    "shape,spread,asym,inv",
    [((40, 56), 9, False, False), ((33, 41), 7, True, True), ((64, 30), 17, False, True),
     ((16, 16), 20, False, False)],
)
def test_brute_sdf_bytes_matches_jax_pallas_kernel(shape, spread, asym, inv):
    """The four cases of tests/test_pallas_brute.py, against the two Pallas
    kernels that the port's two kernels replace (interpret mode)."""
    b = _mask(shape, 0.35, hash((shape, spread)) % 2**31)
    want = np.asarray(jpb.brute_sdf_bytes_pallas(jnp.asarray(b), spread, asym, inv, interpret=True))
    np.testing.assert_array_equal(_port(b, spread, asym, inv), want)


@pytest.mark.parametrize("spread", [1, 2, 5, 12])
@pytest.mark.parametrize("invert", [False, True])
def test_hard_sdf_brute_matches_opencl_oracle(spread, invert):
    img2ch = _img(_mask((33, 29), 0.3, 10 + spread))
    want = oracle.sdf_pipeline_opencl(img2ch, spread=spread, asymmetric=False, use_luminance=False, invert=invert)
    got = tmodel.hard_sdf_brute(torch.from_numpy(img2ch), spread=spread, invert=invert)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("asymmetric", [False, True])
def test_hard_sdf_brute_asymmetric_luminance_matches_oracle_and_jax(asymmetric):
    img2ch = _img(_mask((24, 24), 0.5, 20))
    kw = dict(spread=6, asymmetric=asymmetric, use_luminance=True)
    got = tmodel.hard_sdf_brute(torch.from_numpy(img2ch), **kw).numpy()
    np.testing.assert_array_equal(got, oracle.sdf_pipeline_opencl(img2ch, **kw))
    np.testing.assert_array_equal(got, np.asarray(jmodel.hard_sdf_brute(jnp.asarray(img2ch), **kw)))


def test_diagonal_quirk_reproduced():
    """The 7x7 case of test_brute_parity.py: pixel (3, 3)'s only nearby
    opposite neighbour sits on the exact diagonal, which the reference never
    probes."""
    b = np.ones((7, 7), dtype=bool)
    b[2, 2] = False
    img2ch = _img(b)
    got = tmodel.hard_sdf_brute(torch.from_numpy(img2ch), spread=3).numpy()
    np.testing.assert_array_equal(got, oracle.sdf_pipeline_opencl(img2ch, spread=3))
    d2 = tbrute.triangle_d2(torch.from_numpy(b), tbrute.seed_strips(torch.from_numpy(b), 3), 3)
    assert int(d2[3, 3]) != 2 and oracle.opencl_nearest_d2(b, 3)[3, 3] != 2


@pytest.mark.parametrize("fill", [False, True])
def test_uniform_images_take_the_inf_fallback(fill):
    b = np.full((10, 14), fill)
    got = _port(b, 4)
    np.testing.assert_array_equal(got, oracle.sdf_pipeline_opencl(_img(b), spread=4))
    np.testing.assert_array_equal(got, _xla(b, 4))
    assert len(np.unique(got)) == 1


@pytest.mark.parametrize(
    "shape,spread",
    [((1, 37), 5), ((23, 1), 5), ((1, 1), 3), ((30, 45), 300), ((9, 300), 256)],
)
def test_edge_shapes_and_u16_strips_match_jax_xla(shape, spread):
    """H = 1, W = 1 and spreads whose strips need uint16 (spread + 1 > 255)."""
    b = _mask(shape, 0.3, spread + shape[0])
    strips = cuda_brute.seed_strips(torch.from_numpy(b), spread)
    assert strips.shape == (2, 4) + shape and strips.dtype == cuda_brute.strip_dtype(spread)
    for asymmetric, invert in ((False, False), (True, True)):
        np.testing.assert_array_equal(_port(b, spread, asymmetric, invert), _xla(b, spread, asymmetric, invert))


def test_batch_of_three_matches_jax_per_image():
    b = _mask((3, 24, 32), 0.3, 5)
    got = _port(b, 6)
    np.testing.assert_array_equal(got, _xla(b, 6))
    for i in range(3):
        np.testing.assert_array_equal(got[i], _port(b[i], 6))


def test_zero_255_mask_is_canonicalised():
    """A 0/255 uint8 mask reads as its bool in the pipeline: pass A seeds
    TRUE at code 1 only (ROADMAP Queue 3, hazard 5), and takes uint8 as
    tri-state codes (code 2, and 255, seed neither polarity)."""
    b = _mask((21, 26), 0.4, 8)
    m = torch.from_numpy(np.where(b, 255, 0).astype(np.uint8))
    np.testing.assert_array_equal(cuda_brute.brute_sdf_bytes(m, 5).numpy(), _xla(b, 5))
    np.testing.assert_array_equal(cuda_brute.seed_strips(m // 255, 5).numpy(),
                                  cuda_brute.seed_strips(torch.from_numpy(b), 5).numpy())
    dead = cuda_brute.seed_strips(torch.full((3, 7), 2, dtype=torch.uint8), 5)
    assert bool((dead == 6).all())  # no seed anywhere: every plane reads spread + 1


def test_plain_versions_and_wrappers_agree_on_the_cpu():
    b = torch.from_numpy(_mask((2, 19, 23), 0.3, 9))
    strips = cuda_brute.seed_strips_plain(b, 7)
    assert torch.equal(cuda_brute.seed_strips(b, 7), strips)
    assert torch.equal(cuda_brute.brute_scan_bytes(b, strips, 7, True, True),
                       cuda_brute.brute_scan_bytes_plain(b, strips, 7, True, True))
    assert torch.equal(cuda_brute.brute_sdf_bytes(b, 7), cuda_brute.brute_sdf_bytes_plain(b, 7))


def test_spread_out_of_range_raises():
    b = torch.zeros((4, 4), dtype=torch.bool)
    for spread in (0, cuda_brute.MAX_SPREAD + 1):
        with pytest.raises(ValueError):
            cuda_brute.brute_sdf_bytes(b, spread)
