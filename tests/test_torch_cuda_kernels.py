"""The CUDA kernels against their plain PyTorch versions on the card: the
hard path's (csrc/edt.cu) byte for byte, BRUTE's (csrc/brute.cu) byte for
byte, the exact distance field's (edt_dist) bit for bit, the declared-range soft path's
(csrc/soft_mm.cu) within 1e-4 (field, and dgray relative to its scale), and
the adaptive soft kernels (csrc/soft_fused.cu) bit for bit, with the
gradient of the whole chain within 1e-4 of the scale of autograd, the
composed path's column soft-min pair (csrc/softmin.cu) bit for bit, the
halo kernels (csrc/halo.cu) and the sharded pipelines on logical shards of
the card, and the sharded soft tier's cols-conv kernels (csrc/band_conv.cu)
bit for bit with the soft tiers over logical shards, and the training
step's front end and loss (csrc/soft_front.cu): v bit for bit the torch
chain, its gradients and the loss's within 1e-6 beyond the chain's own
rounding. Marked ``gpu``: each
test skips where no CUDA device is present. This file imports no JAX, so on
a machine without it run it past the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.config import SdfConfig, SoftConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator, signed_distance_field_exact
from chaq_sdfgen_tpu_torch.models.soft_model import SoftSDFModel, create_train_state, make_train_step
from chaq_sdfgen_tpu_torch.ops import (cuda_brute, cuda_edt, cuda_soft_mm, soft_front, soft_fused, soft_mxu, softmin,
                                       softsdf)
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
# the row passes' edges too (csrc/row_words.cuh): a partial 16-pixel word, one
# word, rows wider than a warp's 4096-pixel segment (a row cut into segments),
# a batch whose rows do not fill the last block's 8 warps, a 1024-wide mask
ROW_SHAPES = SHAPES + [(5, 15), (5, 16), (7, 4097), (3, 20000), (3, 7, 33), (64, 1024)]


def _at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """t's values in a tensor whose data starts ``offset`` elements into its
    storage (not 16-byte aligned for a byte tensor and offset 3)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("shape", ROW_SHAPES)
@pytest.mark.parametrize("band", [3, 66, 302, 65530, 65600])
@pytest.mark.parametrize("tri_state", [False, True])
@pytest.mark.parametrize("offset", [0, 3])
def test_edt_rows_matches_plain(dev, shape, band, tri_state, offset):
    codes = _at_offset(_codes(shape, band, tri_state, density=0.05).to(dev), offset)
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


def test_ieee_sqrt_is_the_refined_root_below_2_24(dev):
    """edt_dist takes the IEEE sqrt of minima below 2^24 - 1: on every
    integer there it is numerics.refined_sqrt's root; at 2^24 - 1 the
    refined root rounds up (edt_dist takes the refined one there)."""
    n = torch.arange((1 << 24) - 1, dtype=torch.float32, device=dev)
    assert int((torch.sqrt(n).view(torch.int32) != refined_sqrt(n).view(torch.int32)).sum()) == 0
    top = torch.tensor([(1 << 24) - 1], dtype=torch.float32, device=dev)
    assert float(refined_sqrt(top)) == 4096.0 and float(torch.sqrt(top)) < 4096.0


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
    assert 0 < gen.kernel_time(img, k1=1, k2=3) < 1  # the two-count slope, CUDA events


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


# ------------------------------------------------------- BRUTE and exact distance

BRUTE_SHAPES = [(1, 17), (17, 1), (139, 131), (3, 64, 80), (300, 1100)]


@pytest.mark.parametrize("shape", BRUTE_SHAPES + ROW_SHAPES[len(SHAPES):])
@pytest.mark.parametrize("spread", [1, 12, 254, 300])
@pytest.mark.parametrize("offset", [0, 3])
def test_brute_rows_matches_plain(dev, shape, spread, offset):
    b = _at_offset(_codes(shape, spread, density=0.05).to(dev), offset)
    before = cuda_brute.LAUNCHES["brute_rows"]
    got = cuda_brute.seed_strips(b, spread)
    assert cuda_brute.LAUNCHES["brute_rows"] == before + 1
    want = cuda_brute.seed_strips_plain(b, spread)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == cuda_brute.strip_dtype(spread)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", BRUTE_SHAPES)
@pytest.mark.parametrize("spread,asymmetric,invert", [(1, False, False), (12, True, True), (64, False, True),
                                                      (300, False, False)])
def test_brute_scan_bytes_matches_plain(dev, shape, spread, asymmetric, invert):
    b = _codes(shape, spread + 1, density=0.05).to(dev)
    strips = cuda_brute.seed_strips_plain(b, spread)
    before = cuda_brute.LAUNCHES["brute_scan_bytes"]
    got = cuda_brute.brute_scan_bytes(b, strips, spread, asymmetric, invert)
    assert cuda_brute.LAUNCHES["brute_scan_bytes"] == before + 1
    want = cuda_brute.brute_scan_bytes_plain(b, strips, spread, asymmetric, invert)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("fill", [False, True])
def test_brute_uniform_and_0_255_masks(dev, fill):
    b = torch.full((40, 70), fill, device=dev)
    assert torch.equal(cuda_brute.brute_sdf_bytes(b, 8), cuda_brute.brute_sdf_bytes_plain(b, 8))
    m = (_codes((40, 70), 2).to(dev).to(torch.uint8) * 255)
    assert torch.equal(cuda_brute.brute_sdf_bytes(m, 8), cuda_brute.brute_sdf_bytes_plain(m != 0, 8))


def _scan_mask(kind, shape, seed):
    """Masks whose 32 x 128 blocks take both of brute_scan_staged's paths:
    dense blocks (noise, the border of a half plane) and sparse or uniform
    ones (strokes, a lone seed)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.random(shape) < 0.5
    if kind == "strokes":
        return _stroke_gray(shape, seed) > 0
    if kind == "half":
        m = np.zeros(shape, bool)
        m[..., shape[-2] // 2 + 3 :, :] = True
        return m
    if kind == "one_seed":
        m = np.zeros(shape, bool)
        m[..., shape[-2] // 3, 2] = True
        return m
    m = rng.random(shape) < 0.5  # "mixed": noise on the left half, strokes on the right
    m[..., shape[-1] // 2 :] = _stroke_gray(shape, seed)[..., shape[-1] // 2 :] > 0
    return m


@pytest.mark.parametrize("kind", ["noise", "strokes", "half", "one_seed", "mixed"])
@pytest.mark.parametrize("shape,spread", [((300, 157), 1), ((300, 157), 5), ((517, 301), 64), ((3, 200, 90), 64),
                                          ((260, 64), 254), ((300, 100), 300), ((700, 70), 300),
                                          ((439, 40), 300), ((440, 40), 300)])
def test_brute_scan_bytes_dense_and_sparse_blocks(dev, kind, shape, spread):
    """brute_scan_bytes byte for byte its plain version where blocks take the
    capped walk (and stage or not) and where they stage at once: heights not
    a multiple of 128 and widths not a multiple of 32, a batch, uint8 up to
    spread 254 and uint16 at 300 (staged up to 439 rows, the per-pixel walk
    from 440, where the window passes a block's shared memory by the
    kernel's static part)."""
    b = torch.from_numpy(_scan_mask(kind, shape, spread)).to(dev)
    strips = cuda_brute.seed_strips(b, spread)
    before = cuda_brute.LAUNCHES["brute_scan_bytes"]
    got = cuda_brute.brute_scan_bytes(b, strips, spread)
    assert cuda_brute.LAUNCHES["brute_scan_bytes"] == before + 1
    want = cuda_brute.brute_scan_bytes_plain(b, strips, spread)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,density", [((1, 17), 0.1), ((17, 1), 0.1), ((139, 131), 0.02),
                                           ((3, 64, 80), 0.01), ((300, 1100), 0.001), ((64, 64), 0.0)])
def test_edt_dist_matches_plain(dev, shape, density):
    b = _codes(shape, 9, density=density).to(dev)
    sat = cuda_edt.dist_sat(max(shape[-2:]))
    din, dout = cuda_edt.row_distances_u8(b, sat - 1)
    assert din.dtype == torch.uint16
    before = cuda_edt.LAUNCHES["edt_dist"]
    got = cuda_edt.exact_dist(din, sat)
    assert cuda_edt.LAUNCHES["edt_dist"] == before + 1
    want = cuda_edt.exact_dist_plain(din, sat)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_edt_dist_one_far_seed_and_tall_image(dev):
    for shape, seeds in (((512, 384), [(0, 0)]), ((4104, 128), [(2, 5), (4100, 100)])):
        b = torch.zeros(shape, dtype=torch.bool)
        for y, x in seeds:
            b[y, x] = True
        got = cuda_edt.exact_distance_fields(b.to(dev))
        want = cuda_edt.exact_distance_fields_plain(b.to(dev))
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert torch.equal(got[0].cpu(), cuda_edt.exact_distance_field(b))


def _edt_mask(kind, shape, seed):
    if kind == "empty":
        return np.zeros(shape, bool)
    return _scan_mask(kind, shape, seed)


EDT_KINDS = ["noise", "strokes", "half", "one_seed", "mixed", "empty"]


@pytest.mark.parametrize("kind", EDT_KINDS)
@pytest.mark.parametrize("shape,spread,staged", [((300, 157), 1, True), ((517, 301), 64, True),
                                                 ((3, 200, 90), 64, True), ((130, 33), 253, True),
                                                 ((700, 70), 300, True), ((1800, 40), 798, False),
                                                 ((120, 50), 65600, True), ((900, 24), 65600, False),
                                                 ((1613, 40), 798, True), ((1614, 40), 798, False),
                                                 ((1800, 40), 725, True), ((1800, 40), 726, False),
                                                 ((853, 24), 65600, True), ((854, 24), 65600, False)])
def test_edt_band_bytes_paths_match_plain(dev, kind, shape, spread, staged):
    """edt_band_bytes byte for byte its plain version on every path its
    launcher takes: dense blocks done within K (noise), dense blocks that
    stage for pixels left (the half plane's border), sparse blocks staged at
    once (strokes, a lone seed, no seed), and the per-pixel walk past a
    block's shared memory (uint16 at band 800 over 1800 rows, int32 over 900
    rows), on both sides of that edge (uint16: 1613 and 1614 rows at band
    800, bands 727 and 728 over 1800 rows; int32: 853 and 854 rows); heights
    not a multiple of 128, widths not of 32, a batch. The path is the
    launcher's own answer (chaq_edt_band_staged)."""
    band = spread + 2
    b = torch.from_numpy(_edt_mask(kind, shape, spread)).to(dev)
    din, dout = cuda_edt.row_distances_u8(b, band)
    assert cuda_edt.pass2_staged(shape[-2], band, din.element_size()) == staged
    before = cuda_edt.LAUNCHES["edt_band_bytes"]
    got = cuda_edt.fused_pass2_bytes(din, dout, spread, False, band)
    assert cuda_edt.LAUNCHES["edt_band_bytes"] == before + 1
    want = cuda_edt.fused_pass2_bytes_plain(din, dout, spread, False, band)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("band,rows", [(66, 200), (302, 150), (30, 64), (65602, 100)])
def test_edt_band_bytes_on_halo_frames(dev, band, rows):
    """Pass 2 on shard frames as parallel/sharded.py builds them: `band`
    rows of each neighbour, the dtype's maximum beyond the image; each
    shard's bytes equal the plain version and the one-device rows."""
    full = torch.from_numpy(_edt_mask("mixed", (3 * rows, 70), band)).to(dev)
    din, dout = cuda_edt.row_distances_u8(full, band)
    fill = torch.iinfo(din.dtype).max
    one = cuda_edt.fused_pass2_bytes(din, dout, band - 2, False, band)
    for shard in range(3):
        lo, hi = shard * rows - band, (shard + 1) * rows + band
        frames = []
        for strip in (din, dout):
            f = torch.full((hi - lo, 70), fill, dtype=strip.dtype, device=dev)
            f[max(lo, 0) - lo : min(hi, 3 * rows) - lo] = strip[max(lo, 0) : min(hi, 3 * rows)]
            frames.append(f)
        got = cuda_edt.fused_pass2_bytes(frames[0], frames[1], band - 2, False, band, True, band, rows)
        want = cuda_edt.fused_pass2_bytes_plain(frames[0], frames[1], band - 2, False, band, True, band, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, one[shard * rows : (shard + 1) * rows])


@pytest.mark.parametrize("kind", EDT_KINDS)
@pytest.mark.parametrize("shape", [(300, 157), (3, 200, 90), (517, 301), (129, 33), (4104, 40)])
def test_edt_dist_paths_match_plain(dev, kind, shape):
    """edt_dist_core and edt_dist bit for bit their plain versions on both
    strips: dense tiles done within K (their values, the table and the
    flags after the first launch), tiles that stage their window and table,
    walks that read rows beyond the window from device memory (a lone
    seed), NO_SEED (no seed), the tier sat 16383 (4104 rows); heights not a
    multiple of 16 or 128, widths not of 32, a batch."""
    b = torch.from_numpy(_edt_mask(kind, shape, 11)).to(dev)
    sat = cuda_edt.dist_sat(max(shape[-2:]))
    assert sat == (16383 if shape[0] == 4104 else 8191)
    for d in cuda_edt.row_distances_u8(b, sat - 1):
        out, table, left = cuda_edt.dist_core(d, sat)
        want = cuda_edt.exact_dist_plain(d, sat)
        assert torch.equal(table.to(torch.int32), cuda_edt.dist_table_plain(d, sat).to(torch.int32))
        assert torch.equal(left, cuda_edt.dist_left_plain(d, sat))
        done = (left == 0).repeat_interleave(128, -2).repeat_interleave(32, -1)[..., : d.shape[-2], : d.shape[-1]]
        assert torch.equal(out.view(torch.int32)[done], want.view(torch.int32)[done])
        before = dict(cuda_edt.LAUNCHES)
        got = cuda_edt.exact_dist(d, sat)
        assert cuda_edt.LAUNCHES["edt_dist"] == before["edt_dist"] + 1
        assert cuda_edt.LAUNCHES["edt_dist_core"] == before["edt_dist_core"] + 1
        walked = cuda_edt.dist_walk(d, sat, out, table, left)  # the second launch alone, on the first's outputs
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(walked.view(torch.int32), want.view(torch.int32))
    if kind == "empty":
        assert bool((got.cpu() == 0).all()) and bool((cuda_edt.exact_dist(cuda_edt.row_distances_u8(
            b, sat - 1)[0], sat) == cuda_edt.NO_SEED).all())


def test_brute_and_exact_entry_points_run_their_kernels(dev):
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (96, 80, 2), dtype=np.uint8))
    gen = SDFGenerator(SdfConfig(spread=12, algorithm="brute"), device=dev)
    before = dict(cuda_brute.LAUNCHES)
    out = gen.generate(img)
    one_device = ("brute_rows", "brute_scan_bytes")  # the shards' halo scan is not on this path
    assert all(cuda_brute.LAUNCHES[k] == before[k] + (k in one_device) for k in before)
    assert torch.equal(out.cpu(), SDFGenerator(SdfConfig(spread=12, algorithm="brute"), device="cpu").generate(img))
    jfa_out = SDFGenerator(SdfConfig(spread=12, algorithm="jfa"), device=dev).generate(img)
    assert torch.equal(jfa_out.cpu(), SDFGenerator(SdfConfig(spread=12, algorithm="jfa"), device="cpu").generate(img))
    b = img[..., 1] > 127
    before = dict(cuda_edt.LAUNCHES)
    field = signed_distance_field_exact(b.to(dev))
    assert cuda_edt.LAUNCHES["edt_rows"] == before["edt_rows"] + 1
    assert cuda_edt.LAUNCHES["edt_dist"] == before["edt_dist"] + 2
    assert cuda_edt.LAUNCHES["edt_dist_core"] == before["edt_dist_core"] + 2
    assert torch.equal(field.cpu(), signed_distance_field_exact(b))


def test_brute_and_dist_wrappers_refuse_what_kernels_do_not_take(dev):
    b = torch.zeros((8, 8), dtype=torch.bool, device=dev)
    strips = cuda_brute.seed_strips(b, 5)
    with pytest.raises(ValueError):
        cuda_brute.brute_scan_bytes(b, strips.to(torch.uint16), 5)  # wrong strip dtype
    with pytest.raises(ValueError):
        cuda_brute.brute_scan_bytes(b, strips.cpu(), 5)
    with pytest.raises(ValueError):
        cuda_brute.seed_strips(b.t().contiguous().t()[:, :4], 5)  # strided
    with pytest.raises(TypeError):
        cuda_edt.exact_dist(torch.zeros((8, 8), dtype=torch.uint8, device=dev), 8191)


# ------------------------------------------------------------- soft kernels

SOFT_SHAPES = [(1, 17), (17, 1), (129, 130), (384, 260), (3, 256, 256), (70, 1000)]
SOFT_PARAMS = [(2.0, 1.0), (1.0, 0.5)]  # (tau, T): the bench's and the CLI's


def _soft_case(dev, shape, tau, temperature, seed=0):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    return g, ct, soft_mxu.range_stats(66, tau, temperature, (0.0, 255.0))


@pytest.mark.parametrize("shape", SOFT_SHAPES)
@pytest.mark.parametrize("tau,temperature", SOFT_PARAMS)
@pytest.mark.parametrize("test_above", [True, False])
def test_soft_mm_fwd_matches_plain(dev, shape, tau, temperature, test_above):
    g, _, (k1, k2, c) = _soft_case(dev, shape, tau, temperature)
    before = cuda_soft_mm.LAUNCHES["soft_mm_fwd"]
    f, d2i, d2o = cuda_soft_mm.mm_fused_fwd(g, c, k1, k2, tau, temperature, 1e-6, test_above)
    assert cuda_soft_mm.LAUNCHES["soft_mm_fwd"] == before + 1
    pf, pi, po = cuda_soft_mm.mm_fused_fwd_plain(g, c, k1, k2, tau, temperature, 1e-6, test_above)
    torch.cuda.synchronize()
    for got, want in ((d2i, pi), (d2o, po)):
        assert torch.equal(got >= 1e29, want >= 1e29)  # the same dead windows
        live = want < 1e29
        assert float((got - want).abs()[live].max()) <= 1e-4
    live = (pi < 1e29) & (po < 1e29)
    assert float((f - pf).abs()[live].max()) <= 1e-4
    no_memo = cuda_soft_mm.mm_fused_fwd(g, c, k1, k2, tau, temperature, 1e-6, test_above, memos=False)
    assert torch.equal(no_memo, f)


@pytest.mark.parametrize("shape", SOFT_SHAPES)
@pytest.mark.parametrize("tau,temperature", SOFT_PARAMS)
@pytest.mark.parametrize("test_above", [True, False])
def test_soft_mm_bwd_matches_autograd_of_plain(dev, shape, tau, temperature, test_above):
    g, ct, (k1, k2, c) = _soft_case(dev, shape, tau, temperature, seed=1)
    _, d2i, d2o = cuda_soft_mm.mm_fused_fwd(g, c, k1, k2, tau, temperature, 1e-6, test_above)
    before = cuda_soft_mm.LAUNCHES["soft_mm_bwd"]
    got = cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, g, c, k1, k2, tau, temperature, 1e-6, test_above)
    assert cuda_soft_mm.LAUNCHES["soft_mm_bwd"] == before + 1
    x = g.clone().requires_grad_()
    pf = cuda_soft_mm.mm_fused_fwd_plain(x, c, k1, k2, tau, temperature, 1e-6, test_above, memos=False)
    want, = torch.autograd.grad(pf, x, ct)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("k1,k2", [(0, 0), (1, 16), (10, 10), (16, 1), (16, 16), (3, 10)])
@pytest.mark.parametrize("shape", [(1, 17), (17, 1), (70, 1000), (3, 45, 130), (300, 129)])
def test_soft_mm_bwd_taps_and_tiles(dev, k1, k2, shape):
    """soft_mm_bwd (128-column tiles walking strips of 16-row chunks) with
    tap radii 0-16, k1 != k2, widths and heights that are not multiples of
    a tile and a batch: within 1e-4 of the scale of autograd through the
    plain forward and of mm_fused_bwd_plain."""
    g, ct, (_, _, c) = _soft_case(dev, shape, 2.0, 1.0, seed=k1 + 17 * k2)
    _, d2i, d2o = cuda_soft_mm.mm_fused_fwd_plain(g, c, k1, k2, 2.0, 1.0, 1e-6)
    before = cuda_soft_mm.LAUNCHES["soft_mm_bwd"]
    got = cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, g, c, k1, k2, 2.0, 1.0, 1e-6)
    assert cuda_soft_mm.LAUNCHES["soft_mm_bwd"] == before + 1
    x = g.clone().requires_grad_()
    pf = cuda_soft_mm.mm_fused_fwd_plain(x, c, k1, k2, 2.0, 1.0, 1e-6, memos=False)
    want, = torch.autograd.grad(pf, x, ct)
    plain = cuda_soft_mm.mm_fused_bwd_plain(ct, d2i, d2o, g, c, k1, k2, 2.0, 1.0, 1e-6)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())
    assert float((got - plain).abs().max()) < 1e-4 * float(plain.abs().max())


@pytest.mark.parametrize("k1,k2", [(10, 10), (16, 3), (0, 16)])
@pytest.mark.parametrize("shard", [0, 1, 3])
@pytest.mark.parametrize("two_d", [False, True])
def test_soft_mm_bwd_halo_frames_and_windows(dev, k1, k2, shard, two_d):
    """soft_mm_bwd on the frames and windows the sharded tier passes: shard
    i of 4 along y (its cotangent and memos with k2 halo rows, row_off k2,
    every row live) and, on a 2-D mesh, a tile with k1 halo columns, the
    live columns those inside the image (edge tiles); within 1e-4 of the
    scale of mm_fused_bwd_plain on the same frame, zero outside the live
    columns."""
    rng = np.random.default_rng(31 + shard)
    h, w = 75, 200
    _, _, c = soft_mxu.range_stats(66, 2.0, 1.0, (0.0, 255.0))
    wf = w + 2 * k1 if two_d else w
    cols = ((k1, wf) if shard == 0 else (0, w + k1) if shard == 3 else (0, wf)) if two_d else (0, w)
    ct = torch.from_numpy(rng.standard_normal((2, h + 2 * k2, wf)).astype(np.float32)).to(dev)
    gray = torch.from_numpy((rng.random((2, h, wf)) * 255).astype(np.float32)).to(dev)
    gfr = torch.from_numpy((rng.random((2, h + 2 * k2, wf)) * 255).astype(np.float32)).to(dev)
    _, d2i, d2o = cuda_soft_mm.mm_fused_fwd_plain(gfr, c, k1, k2, 2.0, 1.0, 1e-6)
    if shard == 0:  # the top edge: halo rows beyond the image, zero cotangent and dead memos
        ct[:, :k2] = 0.0
        d2i[:, :k2] = d2o[:, :k2] = soft_mxu.PAD_D2
    if shard == 3:
        ct[:, h + k2:] = 0.0
        d2i[:, h + k2:] = d2o[:, h + k2:] = soft_mxu.PAD_D2
    win = (0, h + 2 * k2) + cols
    got = cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, gray, c, k1, k2, 2.0, 1.0, 1e-6, row_off=k2, window=win)
    want = cuda_soft_mm.mm_fused_bwd_plain(ct, d2i, d2o, gray, c, k1, k2, 2.0, 1.0, 1e-6, row_off=k2,
                                           window=win)
    torch.cuda.synchronize()
    assert got.shape == (2, h, wf)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert not bool(got[..., : cols[0]].any()) and not bool(got[..., cols[1]:].any())


@pytest.mark.parametrize("k1,k2", [(0, 0), (0, 16), (16, 0), (10, 16), (16, 10), (3, 8), (3, 9), (16, 16)])
@pytest.mark.parametrize("shape", [(1, 17), (17, 1), (70, 1000), (3, 45, 130), (300, 129)])
def test_soft_mm_fwd_taps_and_tiles(dev, k1, k2, shape):
    """soft_mm_fwd (the backward's strip walker: 128-column tiles, 16-row
    chunks) with tap radii 0-16, k1 != k2, a chunk's rows in 2 batches (k2
    8) or 3 (k2 9), the staged columns full (k1 16), widths and heights that
    are not multiples of a tile and a batch: field and memos within 1e-4 of
    mm_fused_fwd_plain on live windows, the same dead windows, and the field
    without memos the same."""
    g, _, (_, _, c) = _soft_case(dev, shape, 2.0, 1.0, seed=k1 + 17 * k2)
    before = cuda_soft_mm.LAUNCHES["soft_mm_fwd"]
    f, d2i, d2o = cuda_soft_mm.mm_fused_fwd(g, c, k1, k2, 2.0, 1.0, 1e-6)
    assert cuda_soft_mm.LAUNCHES["soft_mm_fwd"] == before + 1
    pf, pi, po = cuda_soft_mm.mm_fused_fwd_plain(g, c, k1, k2, 2.0, 1.0, 1e-6)
    torch.cuda.synchronize()
    for got, want in ((d2i, pi), (d2o, po)):
        assert torch.equal(got >= 1e29, want >= 1e29)
        live = want < 1e29
        assert not bool(live.any()) or float((got - want).abs()[live].max()) <= 1e-4
    live = (pi < 1e29) & (po < 1e29)
    assert not bool(live.any()) or float((f - pf).abs()[live].max()) <= 1e-4
    assert torch.equal(cuda_soft_mm.mm_fused_fwd(g, c, k1, k2, 2.0, 1.0, 1e-6, memos=False), f)


@pytest.mark.parametrize("k1,k2", [(10, 10), (16, 3), (0, 16)])
@pytest.mark.parametrize("shard", [0, 1, 3])
@pytest.mark.parametrize("two_d", [False, True])
def test_soft_mm_fwd_halo_frames_and_windows(dev, k1, k2, shard, two_d):
    """soft_mm_fwd on the frames and windows the sharded tier passes: shard
    i of 4 along y (its gray with k2 halo rows, row_off k2, the rows beyond
    the image dead at the edges) and, on a 2-D mesh, a tile with k1 halo
    columns, the live columns those inside the image; bit for bit
    mm_fused_fwd_plain on the same frame."""
    rng = np.random.default_rng(41 + shard)
    h, w = 75, 200
    _, _, c = soft_mxu.range_stats(66, 2.0, 1.0, (0.0, 255.0))
    wf = w + 2 * k1 if two_d else w
    cols = ((k1, wf) if shard == 0 else (0, w + k1) if shard == 3 else (0, wf)) if two_d else (0, w)
    rows = (k2, h + 2 * k2) if shard == 0 else (0, h + k2) if shard == 3 else (0, h + 2 * k2)
    g = torch.from_numpy((rng.random((2, h + 2 * k2, wf)) * 255).astype(np.float32)).to(dev)
    win = rows + cols
    got = cuda_soft_mm.mm_fused_fwd(g, c, k1, k2, 2.0, 1.0, 1e-6, row_off=k2, h_out=h, window=win)
    want = cuda_soft_mm.mm_fused_fwd_plain(g, c, k1, k2, 2.0, 1.0, 1e-6, row_off=k2, h_out=h, window=win)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.shape == (2, h, wf) and torch.equal(x, y)


def test_soft_training_step_runs_both_kernels(dev):
    rng = np.random.default_rng(4)
    g = torch.from_numpy((rng.random((300, 200)) * 255).astype(np.float32)).to(dev).requires_grad_()
    before = dict(cuda_soft_mm.LAUNCHES)
    loss = softsdf.soft_sdf_field(g, 64, tau=2.0, temperature=1.0, gray_range=(0.0, 255.0)).sum()
    loss.backward()
    assert cuda_soft_mm.LAUNCHES["soft_mm_fwd"] == before["soft_mm_fwd"] + 1
    assert cuda_soft_mm.LAUNCHES["soft_mm_bwd"] == before["soft_mm_bwd"] + 1
    x = g.detach().cpu().requires_grad_()
    softsdf.soft_sdf_field(x, 64, tau=2.0, temperature=1.0, gray_range=(0.0, 255.0)).sum().backward()
    # CPU and CUDA exp/log differ in the last ulp; the gradient stays close
    assert float((g.grad.cpu() - x.grad).abs().max()) < 2e-3 * float(x.grad.abs().max())


def test_soft_generator_runs_the_forward_kernel(dev):
    img = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (96, 80, 2), dtype=np.uint8))
    gen = SDFGenerator(SdfConfig(spread=12), soft=SoftConfig(), device=dev)
    before = dict(cuda_soft_mm.LAUNCHES)
    out = gen.generate(img)
    assert cuda_soft_mm.LAUNCHES["soft_mm_fwd"] == before["soft_mm_fwd"] + 1
    assert cuda_soft_mm.LAUNCHES["soft_mm_bwd"] == before["soft_mm_bwd"]
    want = SDFGenerator(SdfConfig(spread=12), soft=SoftConfig(), device="cpu").generate(img)
    assert int((out.cpu().int() - want.int()).abs().max()) <= 1
    assert gen.kernel_time(img, iters=3) > 0


def test_soft_wrappers_refuse_what_kernels_do_not_take(dev):
    g = torch.zeros((8, 8), device=dev)
    with pytest.raises(ValueError):
        cuda_soft_mm.mm_fused_fwd(g.t().contiguous().t(), 0.0, 3, 3, 2.0, 1.0, 1e-6)  # strided
    with pytest.raises(TypeError):
        cuda_soft_mm.mm_fused_fwd(g.double(), 0.0, 3, 3, 2.0, 1.0, 1e-6)
    with pytest.raises(ValueError):
        cuda_soft_mm.mm_fused_fwd(g, 0.0, 17, 3, 2.0, 1.0, 1e-6)
    _, a, b = cuda_soft_mm.mm_fused_fwd(g, 0.0, 3, 3, 2.0, 1.0, 1e-6)
    with pytest.raises(ValueError):
        cuda_soft_mm.mm_fused_bwd(g, a[:4], b, g, 0.0, 3, 3, 2.0, 1.0, 1e-6)
    with pytest.raises(ValueError):
        cuda_soft_mm.mm_fused_bwd(g, a.cpu(), b, g, 0.0, 3, 3, 2.0, 1.0, 1e-6)


# ------------------------------------------------- adaptive soft kernels

FUSED_SHAPES = [(1, 17), (17, 1), (129, 130), (384, 260), (3, 100, 90)]
FUSED_PARAMS = [(66, 2.0, 1.0, True, "u8"), (112, 1.0, 0.5, False, "pm2000"), (20, 0.25, 0.5, True, "u8")]


def _fused_case(dev, shape, kind, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (0.0, 255.0) if kind == "u8" else (-2000.0, 2000.0)
    g = torch.from_numpy((rng.random(shape) * (hi - lo) + lo).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    return g, ct


def _counted(name, fn):
    before = soft_fused.LAUNCHES[name]
    out = fn()
    assert soft_fused.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("band,tau,temperature,test_above,kind", FUSED_PARAMS)
def test_soft_fused_kernels_match_plain(dev, shape, band, tau, temperature, test_above, kind):
    """Each of the four kernels against its plain version on the same
    inputs, bit for bit."""
    g, ct = _fused_case(dev, shape, kind, band)
    args = (band, tau, temperature, test_above)
    s1 = _counted("soft_f1", lambda: soft_fused.f1_pass(g, *args))
    s1p = soft_fused.f1_plain(g, *args)
    field, d2 = _counted("soft_f2", lambda: soft_fused.f2_pass(s1p, band, temperature, 1e-6))
    fp, d2p = soft_fused.f2_plain(s1p, band, temperature, 1e-6)
    ds1 = _counted("soft_b2", lambda: soft_fused.b2_pass(ct, d2p, s1p, band, temperature, 1e-6))
    ds1p = soft_fused.b2_plain(ct, d2p, s1p, band, temperature, 1e-6)
    dg = _counted("soft_b1", lambda: soft_fused.b1_pass(g, s1p, ds1p, *args))
    dgp = soft_fused.b1_plain(g, s1p, ds1p, *args)
    torch.cuda.synchronize()
    for got, want in ((s1, s1p), (field, fp), (d2, d2p), (ds1, ds1p), (dg, dgp)):
        assert torch.equal(got, want)
    assert torch.equal(soft_fused.f2_pass(s1p, band, temperature, 1e-6, memos=False), field)


def _stroke_gray(shape, seed):
    """Strokes in +-2040: windows that mix strokes and empty space."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.float32)
    for _ in range(max(1, m.size // 40000)):
        y, x = rng.integers(0, shape[-2]), rng.integers(0, shape[-1])
        m[..., y : y + int(rng.integers(2, 9)), x : x + int(rng.integers(4, 60))] = 1.0
    return m * 4080 - 2040


@pytest.mark.parametrize("band,tau,temperature,kind", [(66, 2.0, 1.0, "pm2000"), (112, 1.0, 0.5, "u8"),
                                                       (112, 2.0, 1.0, "strokes"), (66, 1.0, 8.0, "strokes")])
def test_soft_b2_long_strips_and_halo_blocks_match_plain(dev, band, tau, temperature, kind):
    """soft_b2 where a block's strip outruns its ring (a (2, 1536, 2048)
    batch: the ring wraps within each strip), and on tier 2's halo'd S1
    block (pass2_ext: 1e30 rows beyond the image, a zero cotangent on the
    halo rows), bit for bit its plain version."""
    shape = (2, 1536, 2048)
    if kind == "strokes":
        g = torch.from_numpy(_stroke_gray(shape, band)).to(dev)
        ct = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32)).to(dev)
    else:
        g, ct = _fused_case(dev, shape, kind, band)
    s1 = soft_fused.f1_plain(g, band, tau, temperature)
    _, d2 = soft_fused.f2_plain(s1, band, temperature, 1e-6)
    got = _counted("soft_b2", lambda: soft_fused.b2_pass(ct, d2, s1, band, temperature, 1e-6))
    assert torch.equal(got, soft_fused.b2_plain(ct, d2, s1, band, temperature, 1e-6))
    # shard 0 of 3 over y: its S1 with a halo of band rows, 1e30 above the image
    h = shape[-2] // 3
    s1ext = torch.cat([torch.full_like(s1[..., :band, :], soft_fused.PAD_H), s1[..., : h + band, :]], dim=-2)
    _, d2e = soft_fused.f2_plain(s1ext, band, temperature, 1e-6)
    cte = torch.nn.functional.pad(ct[..., :h, :], (0, 0, band, band)).contiguous()
    got = _counted("soft_b2", lambda: soft_fused.b2_pass(cte, d2e, s1ext.contiguous(), band, temperature, 1e-6))
    torch.cuda.synchronize()
    assert torch.equal(got, soft_fused.b2_plain(cte, d2e, s1ext, band, temperature, 1e-6))


@pytest.mark.parametrize("kind", ["strokes", "pm2000", "u8"])
@pytest.mark.parametrize("shape,band,tau,temperature,test_above", [
    ((300, 520), 66, 2.0, 1.0, True), ((200, 640), 112, 1.0, 0.5, False), ((150, 333), 10, 1.0, 0.5, True),
    ((2, 90, 700), 66, 2.0, 1.0, False), ((6, 9000), 112, 2.0, 1.0, True), ((40, 4097), 66, 1.0, 0.5, True)])
def test_soft_f1_row_tiles_and_strokes(dev, kind, shape, band, tau, temperature, test_above):
    """soft_f1 bit for bit its plain version where warps take both paths
    (strokes in +-2040: long reaches next to strokes; noise: short ones),
    rows of several 4096-pixel tiles, a batch, and a live-row window."""
    if kind == "strokes":
        g = torch.from_numpy(_stroke_gray(shape, band)).to(dev)
    else:
        g, _ = _fused_case(dev, shape, kind, band)
    args = (band, tau, temperature, test_above)
    got = _counted("soft_f1", lambda: soft_fused.f1_pass(g, *args))
    torch.cuda.synchronize()
    assert torch.equal(got, soft_fused.f1_plain(g, *args))
    win = (shape[-2] // 5, shape[-2] - shape[-2] // 4)
    got = soft_fused.f1_pass(g, *args, window=win)
    torch.cuda.synchronize()
    assert torch.equal(got, soft_fused.f1_plain(g, *args, window=win))


@pytest.mark.parametrize("kind", ["strokes", "pm2000", "u8"])
@pytest.mark.parametrize("shape,band,tau,temperature,test_above", [
    ((300, 520), 66, 2.0, 1.0, True), ((200, 640), 112, 1.0, 0.5, False), ((150, 333), 0, 1.0, 0.5, True),
    ((2, 90, 700), 66, 2.0, 1.0, False), ((6, 5000), 112, 2.0, 1.0, True), ((40, 4097), 66, 1.0, 0.5, True),
    ((1, 17), 66, 2.0, 1.0, False), ((17, 1), 112, 1.0, 0.5, True), ((64, 300), 5, 2.0, 1.0, True)])
def test_soft_b1_row_tiles_and_strokes(dev, kind, shape, band, tau, temperature, test_above):
    """soft_b1 bit for bit its plain version where warps take both paths
    (strokes in +-2040: long reaches on the strokes; noise: short ones),
    rows of several 4096-pixel tiles, a batch, bands 0-112, one row or
    column, and a live-row window."""
    if kind == "strokes":
        g = torch.from_numpy(_stroke_gray(shape, band + 1)).to(dev)
    else:
        g, _ = _fused_case(dev, shape, kind, band + 2)
    args = (band, tau, temperature, test_above)
    s1 = soft_fused.f1_plain(g, *args)
    ds1 = torch.from_numpy(np.random.default_rng(band).standard_normal(tuple(s1.shape)).astype(np.float32)).to(dev)
    got = _counted("soft_b1", lambda: soft_fused.b1_pass(g, s1, ds1, *args))
    torch.cuda.synchronize()
    assert torch.equal(got, soft_fused.b1_plain(g, s1, ds1, *args))
    win = (shape[-2] // 5, shape[-2] - shape[-2] // 4)
    got = soft_fused.b1_pass(g, s1, ds1, *args, window=win)
    torch.cuda.synchronize()
    assert torch.equal(got, soft_fused.b1_plain(g, s1, ds1, *args, window=win))


@pytest.mark.parametrize("kind", ["strokes", "pm2000", "u8"])
@pytest.mark.parametrize("shape,band,temperature", [
    ((300, 45), 56, 1.0), ((300, 45), 57, 1.0),  # the window fills 13 segments exactly, then 14
    ((200, 100), 72, 1.0), ((250, 33), 105, 0.5), ((2, 150, 70), 112, 1.0), ((100, 64), 0, 0.5),
    ((37, 31), 1, 1.0), ((1, 17), 66, 1.0), ((17, 1), 112, 0.5), ((95, 40), 5, 1.0), ((97, 40), 20, 0.5),
    ((2, 1536, 2048), 66, 1.0)])
def test_soft_f2_tiles_and_windows(dev, kind, shape, band, temperature):
    """soft_f2 (32 columns x 96 rows a block, each window staged in 16-row
    segments with per-lane minima, a warp's 12 rows bounded by their own
    taps) bit for bit its plain version, field and memos, where windows fill
    their last segment or not, where warps meet long reaches (strokes in
    +-2040) and short ones (noise), on heights and widths that are not
    multiples of a warp's rows, a tile or a block, and a batch."""
    if kind == "strokes":
        g = torch.from_numpy(_stroke_gray(shape, band + 3)).to(dev)
    else:
        g, _ = _fused_case(dev, shape, kind, band + 3)
    s1 = soft_fused.f1_plain(g, band, 2.0, temperature)
    field, d2 = _counted("soft_f2", lambda: soft_fused.f2_pass(s1, band, temperature, 1e-6))
    fp, d2p = soft_fused.f2_plain(s1, band, temperature, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(field, fp) and torch.equal(d2, d2p)
    assert torch.equal(soft_fused.f2_pass(s1, band, temperature, 1e-6, memos=False), field)


@pytest.mark.parametrize("kind", ["strokes", "pm2000"])
@pytest.mark.parametrize("band", [10, 66, 112])
def test_soft_f2_halo_blocks_match_plain(dev, kind, band):
    """soft_f2 on tier 2's halo'd S1 blocks (pass2_ext: each shard's S1 with
    band rows of its neighbours', 1e30 beyond the image) bit for bit its
    plain version on the block, and the cropped field the whole image's."""
    shape = (300, 150)
    if kind == "strokes":
        g = torch.from_numpy(_stroke_gray(shape, band)).to(dev)
    else:
        g, _ = _fused_case(dev, shape, kind, band)
    s1 = soft_fused.f1_plain(g, band, 2.0, 1.0)
    whole = soft_fused.f2_plain(s1, band, 1.0, 1e-6, memos=False)
    pad = torch.full_like(s1[..., :band, :], soft_fused.PAD_H)
    s1p = torch.cat([pad, s1, pad], dim=-2)
    for i in range(3):
        s1ext = s1p[..., i * 100 : i * 100 + 100 + 2 * band, :].contiguous()
        field, d2 = _counted("soft_f2", lambda: soft_fused.f2_pass(s1ext, band, 1.0, 1e-6))
        fp, d2p = soft_fused.f2_plain(s1ext, band, 1.0, 1e-6)
        got = soft_fused.pass2_ext(s1ext, band, 1.0, 1e-6, band)
        torch.cuda.synchronize()
        assert torch.equal(field, fp) and torch.equal(d2, d2p)
        assert torch.equal(got, whole[i * 100 : i * 100 + 100])


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("band,tau,temperature,test_above,kind", FUSED_PARAMS)
def test_soft_fused_chain_matches_autograd_of_plain(dev, shape, band, tau, temperature, test_above, kind):
    """The four kernels under autograd against torch autograd through the
    plain forward: dgray within 1e-4 of the scale plus 1e-7 (autograd's
    T - T sigmoid(-l) cancels to about 2^-24 T where the kernels keep
    T sigmoid(l), and tiny images have tiny gradients)."""
    g, ct = _fused_case(dev, shape, kind, band + 1)
    x = g.clone().requires_grad_()
    (soft_fused.soft_sdf_field_fused(x, band, tau, temperature, 1e-6, test_above) * ct).sum().backward()
    y = g.clone().requires_grad_()
    pf = soft_fused.f2_plain(soft_fused.f1_plain(y, band, tau, temperature, test_above), band,
                             temperature, 1e-6, memos=False)
    want, = torch.autograd.grad(pf, y, ct)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(x.grad).all())
    assert float((x.grad - want).abs().max()) <= 1e-4 * float(want.abs().max()) + 1e-7


@pytest.mark.parametrize("kind,branch", [("u8", "mm"), ("pm2000", "fused")])
def test_soft_gate_launches_its_branch(dev, kind, branch):
    g, ct = _fused_case(dev, (300, 200), kind, 3)
    x = g.clone().requires_grad_()
    mm_before, fused_before = dict(cuda_soft_mm.LAUNCHES), dict(soft_fused.LAUNCHES)
    softsdf.soft_sdf_field(x, 64, tau=2.0, temperature=1.0).sum().backward()
    mm = {k: cuda_soft_mm.LAUNCHES[k] - mm_before[k] for k in mm_before}
    fused = {k: soft_fused.LAUNCHES[k] - fused_before[k] for k in fused_before}
    assert mm == {k: int(branch == "mm") for k in mm}
    assert fused == {k: int(branch == "fused") for k in fused}
    y = g.detach().cpu().requires_grad_()
    softsdf.soft_sdf_field(y, 64, tau=2.0, temperature=1.0).sum().backward()
    # CPU and CUDA exp/log differ in the last ulp; the gradient stays close
    assert float((x.grad.cpu() - y.grad).abs().max()) < 2e-3 * float(y.grad.abs().max())


def test_soft_model_trains_on_the_card(dev):
    rng = np.random.default_rng(6)
    img = torch.from_numpy((rng.random((2, 64, 48, 2)) * 4000 - 2000).astype(np.float32)).to(dev)
    target = torch.from_numpy(rng.standard_normal((2, 64, 48)).astype(np.float32)).to(dev)
    model = SoftSDFModel(8, SoftConfig(tau=2.0, temperature=1.0))
    assert model.log_tau.device.type == "cuda"
    step = make_train_step(model, create_train_state(model, img, lr=5e-2))
    before = dict(soft_fused.LAUNCHES)
    losses = [float(step(img, target)) for _ in range(3)]
    assert all(soft_fused.LAUNCHES[k] == before[k] + 3 for k in before)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_launch_spans_on_the_card(dev):
    """Under torch.profiler every launch of a training step on the card is
    a span launch.<entry>: the forward's on the step's thread and the
    backward's on the thread autograd runs them on."""
    rng = np.random.default_rng(8)
    img = torch.from_numpy((rng.random((2, 64, 48, 2)) * 4000 - 2000).astype(np.float32)).to(dev)
    target = torch.zeros((2, 64, 48), device=dev)
    model = SoftSDFModel(8, SoftConfig(tau=2.0, temperature=1.0))
    step = make_train_step(model, create_train_state(model, img))
    step(img, target)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(img, target)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    for entry in ("chaq_soft_f1", "chaq_soft_f2", "chaq_soft_b2", "chaq_soft_b1"):
        assert names.count(f"launch.{entry}") == 1, names
    assert names.count("soft.step") == 1 and names.count("soft.field.fused") == 1


@pytest.mark.parametrize("kw", [dict(spread=64), dict(spread=9, asymmetric=True, invert=True)])
def test_brute_atlas_on_the_card(dev, kw):
    """atlas_sdf with algorithm="brute" on the card: one brute_rows and one
    brute_scan_bytes launch over the stack, each image byte for byte
    per-image SDFGenerator(BRUTE); under torch.profiler the call records
    sdf.atlas, the threshold, the two BRUTE op spans and their launches."""
    from chaq_sdfgen_tpu_torch.models.atlas import atlas_sdf

    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(np.where(rng.random((3, 96, 130, 2)) < 0.03, 255, 0).astype(np.uint8)).to(dev)
    cfg = SdfConfig(algorithm="brute", **kw)
    before = dict(cuda_brute.LAUNCHES)
    got = atlas_sdf(imgs, cfg)
    torch.cuda.synchronize()
    assert {k: cuda_brute.LAUNCHES[k] - before[k] for k in before} == {
        "brute_rows": 1, "brute_scan_bytes": 1, "brute_scan_bytes_halo": 0}
    gen = SDFGenerator(cfg)
    for i in range(3):
        assert torch.equal(got[i], gen.generate(imgs[i]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        atlas_sdf(imgs, cfg)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    for name in ("sdf.atlas", "sdf.threshold", "sdf.brute_rows", "sdf.brute_scan", "launch.chaq_brute_rows",
                 "launch.chaq_brute_scan_bytes"):
        assert names.count(name) == 1, (name, names)


# ------------------------------------ the training step's front end and loss

FRONT_SHAPES = [(13, 17), (1, 19, 23), (2, 11, 33), (2, 1024, 1030)]


def _front_case(dev, shape, kind, seed):
    """(..., 2) pixels in [0, 255] ("u8") or mapped to (x - 127.5) x 16
    ("pm2040"), and the front end's three input tensors as leaves."""
    x = np.random.default_rng(seed).random(shape + (2,)) * 255
    img = torch.from_numpy((x if kind == "u8" else (x - 127.5) * 16).astype(np.float32)).to(dev)
    ins = [torch.tensor(v, device=dev).requires_grad_() for v in ([0.25, 0.75], 1.5, 2.2)]
    return img, ins


def _front_chain(img2ch, mix, bias, tau, tau_s=2.0):
    """SoftSDFModel.forward's front end as the torch chain it was."""
    gray = (img2ch * mix).sum(-1) - bias
    return (gray - 127.5) / tau * tau_s + 127.5


def _front_grads(fn, img, ins, target, dtype=torch.float32):
    """loss and the gradients of (mix, bias, tau, img2ch) through fn and an
    MSE against target, every input cast to dtype."""
    leaves = [t.detach().to(dtype).requires_grad_() for t in (*ins, img)]
    loss = fn(leaves)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _rel_gaps(got, want):
    """Each of got's tensors against want's, over the larger of its norm and
    the median tensor's, as the benchmark's training cells take them."""
    norms = sorted(float(w.double().norm()) for w in want)
    median = norms[len(norms) // 2]
    return [float((a.double() - b.double()).norm()) / max(float(b.double().norm()), median) for a, b in zip(got, want)]


@pytest.mark.parametrize("shape", FRONT_SHAPES)
@pytest.mark.parametrize("kind", ["u8", "pm2040"])
@pytest.mark.parametrize("offset", [0, 2])
def test_soft_front_v_is_the_chain_bitwise(dev, shape, kind, offset):
    """v bitwise the chain's on the card, so the gate decides as before;
    offset 2 takes the kernel's scalar path (not 16-byte aligned)."""
    img, (mix, bias, tau) = _front_case(dev, shape, kind, len(shape))
    img = _at_offset(img, offset)
    before = soft_front.LAUNCHES["soft_front_fwd"]
    with torch.no_grad():
        v = soft_front.front_fwd(img, mix, bias, tau, 2.0)
        want = _front_chain(img, mix, bias, tau)
    assert soft_front.LAUNCHES["soft_front_fwd"] == before + 1
    assert torch.equal(v, want)


@pytest.mark.parametrize("shape", FRONT_SHAPES)
@pytest.mark.parametrize("kind", ["u8", "pm2040"])
def test_soft_front_and_loss_match_the_chain(dev, shape, kind):
    """The loss and the gradients of mix, bias, tau and the pixels through
    front_end and mse against autograd through the chain on the card: within
    1e-6 of the float64 chain, and within 1e-6 of the float32 chain beyond
    that chain's own gap to float64 (its float32 sums cancel); the pixels'
    and pred's gradients bit for bit the chain's."""
    img, ins = _front_case(dev, shape, kind, 5)
    target = torch.from_numpy(np.random.default_rng(6).uniform(-16, 16, shape).astype(np.float32)).to(dev)

    def ours(leaves):
        v = soft_front.front_end(leaves[3], *leaves[:3], 2.0)
        return soft_front.mse((v - 127.5) / 64.0, target, target.numel())

    def chain(leaves):
        v = _front_chain(leaves[3], *leaves[:3])
        return torch.mean(((v - 127.5) / 64.0 - target.to(v.dtype)) ** 2)

    loss, grads = _front_grads(ours, img, ins, target)
    loss32, grads32 = _front_grads(chain, img, ins, target)
    loss64, grads64 = _front_grads(chain, img, ins, target, torch.float64)
    assert abs(float(loss) - float(loss64)) <= 1e-6 * float(loss64)
    assert abs(float(loss) - float(loss32)) <= 1e-6 * float(loss32)
    own = _rel_gaps(grads[:3], grads64[:3])
    assert max(own) <= 1e-6, own
    chain_own = _rel_gaps(grads32[:3], grads64[:3])
    for gap, slack in zip(_rel_gaps(grads[:3], grads32[:3]), chain_own):
        assert gap <= 1e-6 + slack, (gap, slack)
    assert torch.equal(grads[3], grads32[3])


def test_soft_front_steps_are_deterministic(dev):
    """Two identical forward and backward passes: the same bits."""
    img, ins = _front_case(dev, (2, 1024, 1030), "pm2040", 7)
    target = torch.zeros((2, 1024, 1030), device=dev)

    def ours(leaves):
        return soft_front.mse(soft_front.front_end(leaves[3], *leaves[:3], 2.0) / 64.0, target, target.numel())

    runs = [_front_grads(ours, img, ins, target) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_soft_front_runs_without_a_host_sync(dev):
    img, ins = _front_case(dev, (2, 64, 48), "u8", 8)
    target = torch.zeros((2, 64, 48), device=dev)
    x = img.clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = soft_front.mse(soft_front.front_end(x, *ins, 2.0), target, target.numel())
        grads = torch.autograd.grad(loss, [*ins, x])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_soft_front_takes_strided_pixels_and_refuses_them_below(dev):
    """front_end copies a strided img2ch to a contiguous one; the wrappers
    under it refuse what the kernels do not take."""
    img, (mix, bias, tau) = _front_case(dev, (2, 17, 46), "u8", 9)
    strided = img[:, :, ::2]
    with torch.no_grad():
        assert torch.equal(soft_front.front_end(strided, mix, bias, tau, 2.0), _front_chain(strided, mix, bias, tau))
        with pytest.raises(ValueError, match="contiguous"):
            soft_front.front_fwd(strided, mix, bias, tau, 2.0)
        with pytest.raises(ValueError, match="pixels"):
            soft_front.front_fwd(img[..., :1].contiguous(), mix, bias, tau, 2.0)
        with pytest.raises(ValueError, match="tensors on"):
            soft_front.front_fwd(img, mix.cpu(), bias, tau, 2.0)
        with pytest.raises(ValueError, match="contiguous"):
            soft_front.mse_fwd(img[..., 0], img[..., 1], 10)
        with pytest.raises(ValueError, match="target"):
            soft_front.mse_fwd(img[..., 0].contiguous(), img[:1, ..., 1].contiguous(), 10)
        with pytest.raises(ValueError, match="target"):
            soft_front.mse_bwd(img[..., 0].contiguous(), img[:1, ..., 1].contiguous(), mix[:1].reshape(()), 10)


def test_soft_model_step_launches_each_front_kernel_once(dev):
    rng = np.random.default_rng(10)
    img = torch.from_numpy((rng.random((2, 64, 48, 2)) * 255).astype(np.float32)).to(dev)
    target = torch.from_numpy(rng.standard_normal((2, 64, 48)).astype(np.float32)).to(dev)
    model = SoftSDFModel(8, SoftConfig(tau=2.0, temperature=1.0))
    step = make_train_step(model, create_train_state(model))
    before = dict(soft_front.LAUNCHES)
    step(img, target)
    torch.cuda.synchronize()
    assert {k: soft_front.LAUNCHES[k] - before[k] for k in before} == {k: 1 for k in before}


def test_soft_fused_wrappers_refuse_what_kernels_do_not_take(dev):
    g = torch.zeros((8, 8), device=dev)
    s1 = torch.zeros((2, 8, 8), device=dev)
    with pytest.raises(ValueError):
        soft_fused.f1_pass(g.t().contiguous().t(), 5, 2.0, 1.0)  # strided
    with pytest.raises(TypeError):
        soft_fused.f1_pass(g.double(), 5, 2.0, 1.0)
    with pytest.raises(ValueError):
        soft_fused.f1_pass(g, 113, 2.0, 1.0)
    with pytest.raises(ValueError):
        soft_fused.b2_pass(g, s1[:, :4], s1, 5, 1.0, 1e-6)
    with pytest.raises(ValueError):
        soft_fused.b1_pass(g, s1.cpu(), s1, 5, 2.0, 1.0)


# ------------------------------------------------- composed soft kernels

SOFTMIN_SHAPES = [(1, 17), (17, 1), (139, 131), (3, 64, 80), (4096, 1), (1, 4096)]


def _softmin_case(dev, shape, band, seed):
    """gext (..., H + 2 band, W): heights in [0, 2000) with 1e30 sentinel
    rows above and below, as band_softmin extends them; S; a cotangent."""
    rng = np.random.default_rng(seed)
    h = rng.random(shape).astype(np.float32) * 2000
    pad = [(0, 0)] * (len(shape) - 2) + [(band, band), (0, 0)]
    gext = torch.from_numpy(np.pad(h, pad, constant_values=np.float32(1e30))).to(dev)
    ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    return gext, ct


def _counted_col(name, fn):
    before = softmin.LAUNCHES[name]
    out = fn()
    assert softmin.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("shape", SOFTMIN_SHAPES)
@pytest.mark.parametrize("band,t", [(0, 1.0), (1, 0.5), (113, 1.0), (130, 0.5)])
def test_softmin_kernels_match_plain(dev, shape, band, t):
    """Both kernels against their plain versions on the same inputs, bit
    for bit."""
    gext, ct = _softmin_case(dev, shape, band, band + len(shape))
    s = _counted_col("softmin_col_fwd", lambda: softmin.softmin_col_fwd(gext, band, t))
    sp = softmin.softmin_col_fwd_plain(gext, band, t)
    dg = _counted_col("softmin_col_bwd", lambda: softmin.softmin_col_bwd(gext, sp, ct, band, t))
    dgp = softmin.softmin_col_bwd_plain(gext, sp, ct, band, t)
    torch.cuda.synchronize()
    assert torch.equal(s, sp) and torch.equal(dg, dgp)


def test_softmin_saturated_strip(dev):
    out = softmin.softmin_col_fwd(torch.full((22 + 2 * 130, 16), 1e30, device=dev), 130, 0.5)
    assert bool(torch.isfinite(out).all()) and bool((out > 1e29).all())


def _form_case(dev, shape, band, axis, implicit, seed, nf=1):
    """nf fields (heights in [0, 2000), pre-extended along the axis with
    1e30 unless implicit) and a cotangent of one field's S."""
    rng = np.random.default_rng(seed)
    ext = 0 if implicit else 2 * band
    gshape = list(shape)
    gshape[axis] += ext
    fields = []
    for _ in range(nf):
        h = rng.random(shape).astype(np.float32) * 2000
        pad = [(0, 0)] * len(shape)
        pad[axis] = (0, 0) if implicit else (band, band)
        fields.append(torch.from_numpy(np.pad(h, pad, constant_values=np.float32(1e30))).to(dev))
    return fields


@pytest.mark.parametrize("shape", [(1, 17), (17, 1), (139, 131), (3, 64, 80), (1, 300), (70, 33)])
@pytest.mark.parametrize("band,t", [(0, 1.0), (1, 0.5), (40, 1.0), (130, 0.5)])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("impl", ["auto", "global"])
def test_softmin_forms_match_plain(dev, shape, band, t, axis, implicit, impl):
    """Each form (along y or x, explicit or implicit sentinels) of both
    kernels, staged strip and global-load instance, against the plain
    version on the same inputs, bit for bit; one launch each."""
    (g,) = _form_case(dev, shape, band, axis, implicit, band + len(shape))
    kw = dict(axis=axis, implicit=implicit)
    s = _counted_col("softmin_col_fwd", lambda: softmin.softmin_col_fwd(g, band, t, impl=impl, **kw))
    sp = softmin.softmin_col_fwd_plain(g, band, t, **kw)
    ct = torch.randn(sp.shape, generator=torch.Generator(device=dev).manual_seed(band), device=dev)
    dg = _counted_col("softmin_col_bwd", lambda: softmin.softmin_col_bwd(g, sp, ct, band, t, impl=impl, **kw))
    dgp = softmin.softmin_col_bwd_plain(g, sp, ct, band, t, **kw)
    torch.cuda.synchronize()
    assert dg.shape == g.shape
    assert torch.equal(s, sp) and torch.equal(dg, dgp)


@pytest.mark.parametrize("axis,shape", [(-2, (1500, 4096)), (-1, (2100, 1500))])
@pytest.mark.parametrize("implicit", [False, True])
def test_softmin_long_strips(dev, axis, shape, implicit):
    """Shapes whose strips run long enough for the staged rings to wrap,
    against the plain version, bit for bit."""
    (g,) = _form_case(dev, shape, 130, axis, implicit, 11)
    kw = dict(axis=axis, implicit=implicit)
    s = softmin.softmin_col_fwd(g, 130, 1.0, **kw)
    sp = softmin.softmin_col_fwd_plain(g, 130, 1.0, **kw)
    ct = torch.randn(sp.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    dg = softmin.softmin_col_bwd(g, sp, ct, 130, 1.0, **kw)
    dgp = softmin.softmin_col_bwd_plain(g, sp, ct, 130, 1.0, **kw)
    torch.cuda.synchronize()
    assert torch.equal(s, sp) and torch.equal(dg, dgp)


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("implicit", [False, True])
def test_softmin_two_fields_in_place(dev, axis, implicit):
    """Two fields in one launch each way, written at a column offset of a
    wider output and read back from there, against the plain version."""
    band, t = 37, 1.0
    fields = _form_case(dev, (2, 90, 75), band, axis, implicit, 3, nf=2)
    width = softmin.softmin_col_fwd_plain(fields[0], band, t, axis=axis, implicit=implicit).shape[-1]
    out = torch.full((2, 90, 5 + 2 * width + 3), 7.0, device=dev)
    want = out.clone()
    kw = dict(axis=axis, implicit=implicit)
    _counted_col("softmin_col_fwd", lambda: softmin.softmin_col_fwd(tuple(fields), band, t, out=out, out_col=5, **kw))
    softmin.softmin_col_fwd_plain(tuple(fields), band, t, out=want, out_col=5, **kw)
    ct = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    dg = _counted_col("softmin_col_bwd",
                      lambda: softmin.softmin_col_bwd(tuple(fields), want, ct, band, t, s_col=5, **kw))
    dgp = softmin.softmin_col_bwd_plain(tuple(fields), want, ct, band, t, s_col=5, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(dg, dgp))


@pytest.mark.parametrize("axis,band", [(-2, 722), (-1, 1922)])
def test_softmin_past_the_staged_limit(dev, axis, band):
    """Past the staged instance's shared memory (band 721 along y, 1921 along
    x): the global-load instance, bit for bit; asking for the staged
    instance there raises."""
    assert not softmin.staged_fits(band, axis) and softmin.staged_fits(band - 4, axis)
    (g,) = _form_case(dev, (1600, 40) if axis == -2 else (40, 4100), band, axis, True, 5)
    s = softmin.softmin_col_fwd(g, band, 1.0, axis=axis, implicit=True)
    sp = softmin.softmin_col_fwd_plain(g, band, 1.0, axis=axis, implicit=True)
    ct = torch.ones_like(sp)
    dg = softmin.softmin_col_bwd(g, sp, ct, band, 1.0, axis=axis, implicit=True)
    dgp = softmin.softmin_col_bwd_plain(g, sp, ct, band, 1.0, axis=axis, implicit=True)
    torch.cuda.synchronize()
    assert torch.equal(s, sp) and torch.equal(dg, dgp)
    with pytest.raises(ValueError):
        softmin.softmin_col_fwd(g, band, 1.0, axis=axis, implicit=True, impl="staged")


@pytest.mark.parametrize("shape,spread", [((300, 200), 111), ((1, 500), 64), ((2, 40, 60), 128)])
def test_composed_path_launches_three_each_way(dev, shape, spread, monkeypatch):
    """soft_sdf_field past the adaptive kernels' geometry: 2 forward and 2
    backward launches (pass 1 on both fields in one launch, pass 2), no
    other soft kernel; the field and gradient equal the same path with the
    plain versions in the kernels' place, bit for bit."""
    g, ct = _fused_case(dev, shape, "pm2000", spread)
    x = g.clone().requires_grad_()
    before = {**cuda_soft_mm.LAUNCHES, **soft_fused.LAUNCHES, **softmin.LAUNCHES}
    field = softsdf.soft_sdf_field(x, spread, tau=2.0, temperature=1.0)
    (field * ct).sum().backward()
    after = {**cuda_soft_mm.LAUNCHES, **soft_fused.LAUNCHES, **softmin.LAUNCHES}
    grew = {k: after[k] - before[k] for k in after}
    assert grew == {k: 2 if k.startswith("softmin") else 0 for k in grew}
    monkeypatch.setattr(softmin, "softmin_col_fwd", softmin.softmin_col_fwd_plain)
    monkeypatch.setattr(softmin, "softmin_col_bwd", softmin.softmin_col_bwd_plain)
    y = g.clone().requires_grad_()
    plain = softsdf.soft_sdf_field(y, spread, tau=2.0, temperature=1.0)
    (plain * ct).sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(field, plain) and torch.equal(x.grad, y.grad)


def test_wide_taps_launch_no_kernel(dev):
    """The declared range at tau 2, T 8 (k = 28, 29): float32 matrix
    products, no kernel of the package; field within 1e-4 and gradient
    within 1e-4 of the scale of the shifted-slice form."""
    g = torch.from_numpy(np.where(np.random.default_rng(2).random((200, 260)) < 0.02, 250.0, 5.0)
                         .astype(np.float32)).to(dev)
    ct = torch.ones_like(g)
    before = {**cuda_soft_mm.LAUNCHES, **soft_fused.LAUNCHES, **softmin.LAUNCHES}
    x = g.clone().requires_grad_()
    (softsdf.soft_sdf_field(x, 64, tau=2.0, temperature=8.0, gray_range=(0.0, 255.0)) * ct).sum().backward()
    assert {**cuda_soft_mm.LAUNCHES, **soft_fused.LAUNCHES, **softmin.LAUNCHES} == before
    k1, k2, c = soft_mxu.range_stats(66, 2.0, 8.0, (0.0, 255.0))
    y = g.clone().requires_grad_()
    plain = soft_mxu.soft_field_collapsed(y, k1, k2, c, 2.0, 8.0, 1e-6)[0]
    (plain * ct).sum().backward()
    field = softsdf.soft_sdf_field(g, 64, tau=2.0, temperature=8.0, gray_range=(0.0, 255.0))
    assert float((field - plain.detach()).abs().max()) <= 1e-4
    assert float((x.grad - y.grad).abs().max()) <= 1e-4 * float(y.grad.abs().max())


def test_softmin_wrappers_refuse_what_kernels_do_not_take(dev):
    g = torch.zeros((20, 8), device=dev)
    s = torch.zeros((10, 8), device=dev)
    with pytest.raises(ValueError):
        softmin.softmin_col_fwd(g.t().contiguous().t(), 5, 1.0)  # strided
    with pytest.raises(TypeError):
        softmin.softmin_col_fwd(g.double(), 5, 1.0)
    with pytest.raises(ValueError):
        softmin.softmin_col_fwd(g, 11, 1.0)  # fewer than 2 band rows
    with pytest.raises(ValueError):
        softmin.softmin_col_bwd(g, s[:4], s, 5, 1.0)
    with pytest.raises(ValueError):
        softmin.softmin_col_bwd(g, s.cpu(), s, 5, 1.0)


# ------------------------------------------------- the sharded tier (rows 16, 20, 21)


def _logical(dev, shape, names=("y",)):
    from chaq_sdfgen_tpu_torch.parallel import mesh

    return mesh.make_mesh(shape, names, devices=[dev] * int(np.prod(shape)))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int32])
@pytest.mark.parametrize("shape,row_off,out_rows", [((3, 100, 130), 20, 60), ((40, 70), 0, 40), ((1, 17), 0, 1),
                                                     ((90, 33), 33, 24)])
def test_edt_band_bytes_row_offset_matches_plain(dev, dtype, shape, row_off, out_rows):
    """Pass 2 on halo'd strips: output row y reads strip row y + row_off;
    the int32 strips serve bands above 65534."""
    band = {torch.uint8: 30, torch.uint16: 400, torch.int32: 65602}[dtype]
    din, dout = cuda_edt.row_distances_u8_plain(_codes(shape, row_off, density=0.03).to(dev), band)
    assert din.dtype == dtype
    before = cuda_edt.LAUNCHES["edt_band_bytes"]
    got = cuda_edt.fused_pass2_bytes(din, dout, band - 2, False, band, True, row_off, out_rows)
    assert cuda_edt.LAUNCHES["edt_band_bytes"] == before + 1
    want = cuda_edt.fused_pass2_bytes_plain(din, dout, band - 2, False, band, True, row_off, out_rows)
    torch.cuda.synchronize()
    assert got.shape == shape[:-2] + (out_rows, shape[-1]) and torch.equal(got, want)


def test_edt_int32_strips_match_plain(dev):
    codes = _codes((3, 60, 90), 4, tri_state=True).to(dev)
    din, dout = cuda_edt.row_distances_u8(codes, 70000)
    pin, pout = cuda_edt.row_distances_u8_plain(codes, 70000)
    assert din.dtype == torch.int32 and torch.equal(din, pin) and torch.equal(dout, pout)
    b = _codes((64, 80), 5, density=0.01).to(dev)
    assert torch.equal(cuda_edt.fused_sdf_bytes(b, 65600), cuda_edt.fused_sdf_bytes_plain(b, 65600))


@pytest.mark.parametrize("spread,n,hs_extra,asymmetric,invert", [(5, 1, (5, 5), False, False),
                                                                 (64, 2, (64, 64), True, True),
                                                                 (40, 1, (0, 40), False, True),
                                                                 (254, 1, (254, 7), False, False),
                                                                 (300, 1, (100, 50), False, False),
                                                                 (300, 2, (300, 300), True, False)])
def test_brute_scan_bytes_halo_matches_plain(dev, spread, n, hs_extra, asymmetric, invert):
    """Row 16 on planes that are not pass-A output at all (the scan is
    defined on any), with halo rows above and below the shard; at spread 300
    uint16 frames, of 198 rows (the staged kernel) and of 648 (past its
    shared memory: the per-pixel walk)."""
    h, w = 48, 150
    top, bottom = hs_extra
    rng = np.random.default_rng(spread)
    dtype = np.uint8 if cuda_brute.strip_dtype(spread) == torch.uint8 else np.uint16
    strips = torch.from_numpy(rng.integers(0, spread + 2, size=(2, 4, n, top + h + bottom, w), dtype=dtype))
    b = _codes((n, h, w), spread, density=0.4)
    strips, b = strips.to(dev), b.to(dev)
    before = cuda_brute.LAUNCHES["brute_scan_bytes_halo"]
    got = cuda_brute.brute_scan_bytes_halo(b, strips, spread, top, asymmetric, invert)
    assert cuda_brute.LAUNCHES["brute_scan_bytes_halo"] == before + 1
    want = cuda_brute.brute_scan_bytes_halo_plain(b, strips, spread, top, asymmetric, invert)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int32, torch.float32])
@pytest.mark.parametrize("n,h,w,band", [(4, 32, 4096, 5), (4, 16, 33, 16), (3, 8, 130, 1), (8, 8, 96, 17)])
def test_halo_kernels_match_plain(dev, dtype, n, h, w, band):
    from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo

    rng = np.random.default_rng(n * h + band)
    blocks = [torch.from_numpy(rng.integers(0, 1000, size=(2, h, w)).astype(np.int32)).to(dtype).to(dev)
              for _ in range(n)]
    fill = {torch.uint8: 255, torch.uint16: 65535, torch.int32: -1, torch.float32: -7.25}[dtype]
    before = dict(cuda_halo.LAUNCHES)
    if band <= h:
        got = cuda_halo.halo_slab(blocks, band, fill)
        want = cuda_halo.halo_slab_plain(blocks, band, fill)
        assert cuda_halo.LAUNCHES["halo_slab"] == before["halo_slab"] + 1  # one launch per exchange and device
        for a, b_ in zip(got[0] + got[1], want[0] + want[1]):
            assert torch.equal(a, b_)
    up, dn = cuda_halo.halo_ring_shift(blocks, blocks[::-1])
    pu, pd = cuda_halo.halo_ring_shift_plain(blocks, blocks[::-1])
    assert all(torch.equal(a, b_) for a, b_ in zip(up + dn, pu + pd))
    ext = cuda_halo.exchange_row_halo_rdma(blocks, band, fill)
    plain = halo.exchange_row_halo(blocks, band, fill)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(ext, plain))


@pytest.mark.parametrize("kind", ["strokes", "noise", "far_seed", "uniform"])
@pytest.mark.parametrize("spread,h,w,hs_extra", [(64, 300, 157, (64, 64)), (20, 260, 64, (45, 3)),
                                                 (253, 140, 33, (253, 253)), (300, 90, 70, (120, 0)),
                                                 (64, 517, 301, (0, 0))])
def test_brute_scan_bytes_halo_staged_on_pass_a_frames(dev, kind, spread, h, w, hs_extra):
    """The staged halo scan on pass-A planes of a frame cut from a larger
    mask: several 128-row tiles, odd widths, halos wider than the spread,
    uint8 up to spread 253 (windows of up to 634 rows) and a uint16 frame
    that fits, and one device's frame (row_off 0, hs = h): byte for byte its
    plain version and the one-device scan of the whole mask."""
    top, bottom = hs_extra
    rng = np.random.default_rng(spread + h)
    full_shape = (top + h + bottom, w)
    if kind == "strokes":
        mask = torch.from_numpy(_stroke_gray(full_shape, spread) > 0)
    elif kind == "noise":
        mask = torch.from_numpy(rng.random(full_shape) < 0.3)
    elif kind == "far_seed":
        mask = torch.zeros(full_shape, dtype=torch.bool)
        mask[1, 2] = True
    else:
        mask = torch.zeros(full_shape, dtype=torch.bool)
    mask = mask.to(dev)
    strips = cuda_brute.seed_strips(mask, spread)
    b = mask[top : top + h].contiguous()
    before = cuda_brute.LAUNCHES["brute_scan_bytes_halo"]
    got = cuda_brute.brute_scan_bytes_halo(b, strips, spread, top)
    assert cuda_brute.LAUNCHES["brute_scan_bytes_halo"] == before + 1
    want = cuda_brute.brute_scan_bytes_halo_plain(b, strips, spread, top)
    whole = cuda_brute.brute_scan_bytes(mask, strips, spread)[top : top + h]
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, whole)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.int32, torch.float32])
@pytest.mark.parametrize("n,h,w,band", [(4, 32, 4096, 5), (4, 16, 33, 16), (3, 8, 130, 1), (8, 8, 96, 17),
                                        (4, 6, 50, 14), (1, 8, 64, 3)])
def test_halo_frames_match_ppermute(dev, dtype, n, h, w, band):
    """The frames written in place, bit for bit the ppermute form: one
    halo_slab launch where the band fits in a shard, else one
    halo_ring_shift launch for every hop; plane stacks of (2, 4, h, W) too."""
    from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo

    rng = np.random.default_rng(n * h + band + w)
    fill = {torch.uint8: 255, torch.uint16: 65535, torch.int32: -1, torch.float32: -7.25}[dtype]
    for shape in ((2, h, w), (2, 4, h, w)):
        blocks = [torch.from_numpy(rng.integers(0, 60000, size=shape)).to(dtype).to(dev) for _ in range(n)]
        before = dict(cuda_halo.LAUNCHES)
        got = cuda_halo.exchange_row_halo_rdma(blocks, band, fill)
        hops = -(-band // h)
        assert cuda_halo.LAUNCHES["halo_slab"] == before["halo_slab"] + (hops == 1)
        assert cuda_halo.LAUNCHES["halo_ring_shift"] == before["halo_ring_shift"] + (hops > 1)
        want = halo.exchange_row_halo(blocks, band, fill)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b_) for a, b_ in zip(got, want))


def test_halo_table_longer_than_a_launch(dev):
    """32 shards' frames: 96 jobs, two launches of at most 64."""
    from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo

    rng = np.random.default_rng(32)
    blocks = [torch.from_numpy(rng.integers(0, 255, size=(8, 40), dtype=np.uint8)).to(dev) for _ in range(32)]
    before = cuda_halo.LAUNCHES["halo_slab"]
    got = cuda_halo.exchange_row_halo_rdma(blocks, 3, 7)
    assert cuda_halo.LAUNCHES["halo_slab"] == before + 2
    want = halo.exchange_row_halo(blocks, 3, 7)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))


def test_tier_1a_backward_exchanges_three_arrays_in_one_launch(dev):
    """The declared chain's backward: the cotangent and both memos in one
    halo_slab launch, the gradient bit for bit the ppermute form's."""
    from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo

    rng = np.random.default_rng(1)
    k1, k2, shift = soft_mxu.range_stats(66, 2.0, 1.0, (0.0, 255.0))
    gray = torch.from_numpy(rng.integers(0, 256, size=(512, 96)).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.standard_normal((128, 96)).astype(np.float32)).to(dev)
    windows = [(max(0, k2 - i * 128), min(128 + 2 * k2, k2 + (4 - i) * 128), 0, 96) for i in range(4)]
    grads = []
    for frames in (cuda_halo.exchange_row_halo_rdma_many, halo.exchange_row_halo_many):
        blocks = [b.clone().requires_grad_() for b in gray.split(128)]
        fields = cuda_soft_mm.sharded_mm_fused(blocks, frames, windows, k1, k2, shift, 2.0, 1.0, 1e-6)
        loss = sum((f * ct).sum() for f in fields)
        before = cuda_halo.LAUNCHES["halo_slab"]
        loss.backward()
        assert cuda_halo.LAUNCHES["halo_slab"] == before + (frames is cuda_halo.exchange_row_halo_rdma_many)
        grads.append(torch.cat([b.grad for b in blocks]))
    torch.cuda.synchronize()
    assert torch.equal(grads[0], grads[1])


def test_halo_wrappers_refuse_what_kernels_do_not_take(dev):
    from chaq_sdfgen_tpu_torch.parallel import cuda_halo

    g = [torch.zeros((8, 8), device=dev) for _ in range(2)]
    with pytest.raises(ValueError):
        cuda_halo.halo_slab([g[0], g[1][:4]], 2, 0.0)
    with pytest.raises(ValueError):
        cuda_halo.halo_slab([g[0], g[1].t()], 2, 0.0)  # strided
    with pytest.raises(TypeError):
        cuda_halo.halo_slab([t.double() for t in g], 2, 0.0)
    # blocks that need a gradient are taken: the rdma VJP equals the ppermute one, one hop and two
    from chaq_sdfgen_tpu_torch.parallel import halo

    rng = np.random.default_rng(9)
    for band in (3, 12):
        x = [torch.from_numpy(rng.standard_normal((2, 8, 8)).astype(np.float32)).to(dev) for _ in range(4)]
        ct = [torch.from_numpy(rng.standard_normal((2, 8 + 2 * band, 8)).astype(np.float32)).to(dev)
              for _ in range(4)]
        grads = []
        for exchange in (cuda_halo.exchange_row_halo_rdma, halo.exchange_row_halo):
            xs = [t.clone().requires_grad_() for t in x]
            sum((e * c).sum() for e, c in zip(exchange(xs, band, 0.0), ct)).backward()
            grads.append(torch.cat([t.grad for t in xs], dim=-2))
        torch.cuda.synchronize()
        assert float((grads[0] - grads[1]).abs().max()) <= 1e-6 * float(grads[1].abs().max())


@pytest.mark.parametrize("mesh_shape,names", [((4,), ("y",)), ((2, 2), ("y", "x")), ((16,), ("y",))])
@pytest.mark.parametrize("impl", ["ppermute", "rdma"])
def test_sharded_pipelines_on_logical_shards(dev, mesh_shape, names, impl):
    """EXACT (u8 and u16 strips) and BRUTE over logical shards of one card,
    byte for byte the single-device kernels; 16 shards of 8 rows make the
    halos multi-hop. Only rdma launches the halo kernels."""
    from chaq_sdfgen_tpu_torch.parallel import cuda_halo, sharded

    m = _logical(dev, mesh_shape, names)
    x_axis = "x" if len(names) == 2 else None
    b = _codes((128, 192), 3, density=0.05).to(dev)
    halo_before = sum(cuda_halo.LAUNCHES.values())
    for spread in (9, 30, 300):
        got = sharded.sharded_hard_sdf_bytes(b, spread, m, halo=impl, x_axis=x_axis)
        assert torch.equal(got, cuda_edt.fused_sdf_bytes(b, spread))
    before = cuda_brute.LAUNCHES["brute_scan_bytes_halo"]
    for spread in (9, 30):
        got = sharded.sharded_brute_sdf_bytes(b, spread, m, halo=impl, x_axis=x_axis)
        assert torch.equal(got, cuda_brute.brute_sdf_bytes(b, spread))
    assert cuda_brute.LAUNCHES["brute_scan_bytes_halo"] == before + 2 * int(np.prod(mesh_shape))
    torch.cuda.synchronize()
    assert (sum(cuda_halo.LAUNCHES.values()) > halo_before) == (impl == "rdma")


def test_sharded_jfa_and_batch_on_logical_shards(dev):
    from chaq_sdfgen_tpu_torch.ops import jfa
    from chaq_sdfgen_tpu_torch.parallel import sharded

    b = _codes((128, 96), 6, density=0.01).to(dev)
    for shape, names, x_axis in (((4,), ("y",), None), ((2, 2), ("y", "x"), "x")):
        got = sharded.sharded_jfa_distance(b, _logical(dev, shape, names), x_axis=x_axis)
        assert torch.equal(got, jfa.jfa_distance(b))
    stack = _codes((4, 64, 48), 7, density=0.05).to(dev)
    m = _logical(dev, (2, 2), ("data", "y"))
    for impl in ("ppermute", "rdma"):
        assert torch.equal(sharded.sharded_hard_sdf_bytes(stack, 12, m, batch_axis="data", halo=impl),
                           cuda_edt.fused_sdf_bytes(stack, 12))
        assert torch.equal(sharded.sharded_brute_sdf_bytes(stack, 12, m, batch_axis="data", halo=impl),
                           cuda_brute.brute_sdf_bytes(stack, 12))


def test_sharded_generator_on_distinct_cards(dev):
    """Distinct cards: peer access, cross-device events; skips below 2."""
    from chaq_sdfgen_tpu_torch.config import ShardingConfig

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 CUDA devices")
    img = np.random.default_rng(8).integers(0, 256, size=(64 * n, 96, 2), dtype=np.uint8)
    for algorithm in ("exact", "brute", "jfa"):
        cfg = SdfConfig(spread=9, algorithm=algorithm)
        want = SDFGenerator(cfg, device=dev).generate(img)
        for impl in ("ppermute", "rdma"):
            gen = SDFGenerator(cfg, sharding=ShardingConfig((n,), ("y",), halo_impl=impl), device=dev)
            assert len({d.index for d in gen._mesh.devices.flat}) == n
            assert torch.equal(gen.generate(img), want)


# --------------------------------------------------- sharded soft kernels


@pytest.mark.parametrize("shape,k", [
    ((3, 40, 70), 5), ((100, 130), 16), ((1, 300, 65), 29), ((70, 9), 128),
    # the column walker's edges: 4096-wide shards (strip boundaries inside
    # the frame), strips of several chunks (3 images: fewer strips a tile),
    # and radii from 0 to the unrolled tap loop's 128
    ((300, 4096), 29), ((300, 4096), 10), ((3, 600, 4096), 17), ((2, 77, 33), 0), ((130, 100), 32),
    ((1, 200, 40), 33), ((64, 32), 1),
])
def test_band_conv_kernels_match_plain(dev, shape, k):
    """Rows 17-19 (csrc/band_conv.cu) against their plain versions, bit for
    bit: the cols conv to a halo'd slab's interior and back onto it, pass 2
    fused forward (with and without memos) and backward."""
    from chaq_sdfgen_tpu_torch.ops import band_conv

    rng = np.random.default_rng(k)
    *lead, h, w = shape
    a = [torch.from_numpy((rng.random((*lead, h + 2 * k, w)) * 2).astype(np.float32)).to(dev) for _ in range(2)]
    a[1][..., : w // 3 + 1] = 0.0  # dead windows: columns with nothing live
    ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    t, shift = (8.0, 30.0) if k > 16 else (1.0, 3.0)
    before = dict(band_conv.LAUNCHES)
    got = band_conv.cols_conv(a[0], k, t)
    assert torch.equal(got, band_conv.cols_conv_plain(a[0], k, t, k, h))
    back = band_conv.cols_conv(ct, k, t, -k, h + 2 * k)
    assert torch.equal(back, band_conv.cols_conv_plain(ct, k, t, -k, h + 2 * k))
    f, d2i, d2o = band_conv.p2_fused_fwd(a[0], a[1], k, t, shift, 1e-6)
    for x, y in zip((f, d2i, d2o), band_conv.p2_fused_fwd_plain(a[0], a[1], k, t, shift, 1e-6)):
        assert torch.equal(x, y)
    assert bool((d2o >= 1e29).any())
    assert torch.equal(band_conv.p2_fused_fwd(a[0], a[1], k, t, shift, 1e-6, memos=False), f)
    for x, y in zip(band_conv.p2_fused_bwd(ct, d2i, d2o, k, t, shift, 1e-6),
                    band_conv.p2_fused_bwd_plain(ct, d2i, d2o, k, t, shift, 1e-6)):
        assert x.shape == (*lead, h + 2 * k, w) and torch.equal(x, y)
    torch.cuda.synchronize()
    assert {n: band_conv.LAUNCHES[n] - before[n] for n in before} == {
        "cols_conv": 2, "p2_fused_fwd": 2, "p2_fused_bwd": 1}


def _run_classes(rng, shape, probs):
    """A class a pixel, in runs of 1-40 rows down each column."""
    cls = np.empty(shape, np.int64)
    for x in range(shape[1]):
        y = 0
        while y < shape[0]:
            n = int(rng.integers(1, 41))
            cls[y : y + n, x] = rng.choice(len(probs), p=probs)
            y += n
    return cls


def _sqrt_paths(d2, eps):
    """Whether some 8-row run of a column has every argument x = max(d2, 0)
    + eps of the tails' square roots in [2^-100, 2^100] (the fast paths),
    and whether some run mixes such x with others (the IEEE intrinsics for
    all 8)."""
    x = torch.where(d2 > 0, d2, torch.zeros((), device=d2.device)) + eps
    fast = ((x >= 2.0**-100) & (x <= 2.0**100)).cpu()
    runs = fast[: fast.shape[0] // 8 * 8].reshape(-1, 8, fast.shape[1])
    return bool(runs.all(1).any()), bool((runs.any(1) & ~runs.all(1)).any())


@pytest.mark.parametrize("k", [0, 10])
def test_band_conv_tails_fast_and_ieee_paths(dev, k):
    """The batched tails and VJP (soft_tails.cuh: soft_dist_many) take the
    fast paths of sqrt and rcp where all 8 arguments of a thread's batch lie
    in [2^-100, 2^100], else __fsqrt_rn and __frcp_rn for all 8. Against the
    plain versions bit for bit, eps 0: the forward on sums whose arguments
    mix in-range values with 0 and with values above 2^100 (T 2^95); the
    backward on memos log-uniform from 2^-149 (subnormal) to 2^96, every
    live magnitude, with memos above 2^100 and dead ones (1e30) among them,
    and on columns of memos in [2^-100, 2^96] alone, whose batches all take
    the fast paths (T 2^91, the cotangent scaled by 2^-60 to keep every ds
    finite)."""
    from chaq_sdfgen_tpu_torch.ops import band_conv

    rng = np.random.default_rng(200 + k)
    h, w = 200, 512

    def sums():  # in range, x = 0 (s >= 1), above 2^100 (s < 1.2e-14), dead
        cls = _run_classes(rng, (h + 2 * k, w), [0.5, 0.2, 0.2, 0.1])
        v = np.select([cls == 0, cls == 1, cls == 2],
                      [10 ** rng.uniform(-13, -0.3, cls.shape), rng.uniform(1, 2, cls.shape),
                       10 ** rng.uniform(-20, -16, cls.shape)], 0.0)
        return torch.from_numpy(v.astype(np.float32)).to(dev)

    a_in, a_out = sums(), sums()
    fwd = (k, 2.0**95, 0.0, 0.0)
    got = band_conv.p2_fused_fwd(a_in, a_out, *fwd)
    want = band_conv.p2_fused_fwd_plain(a_in, a_out, *fwd)
    for x, y in zip(got, want):
        assert torch.isfinite(y).all() and torch.equal(x, y)
    for d2 in want[1:]:
        assert _sqrt_paths(d2, 0.0) == (True, True)
        assert bool((d2 <= 0).any()) and bool((d2 > 2.0**100).any())

    def memos():  # half the columns in [2^-100, 2^96] (every batch fast), the rest mixed
        pure = rng.random(w) < 0.5
        m = np.ldexp(rng.uniform(1, 2, (h, w)),
                     np.floor(rng.uniform(np.where(pure, -100, -149), 96, (h, w))).astype(np.int64))
        u = np.where(pure, 1.0, rng.random((h, w)))
        m = np.where(u < 0.05, np.ldexp(rng.uniform(1, 2, (h, w)), rng.integers(101, 127, (h, w))), m)
        m = np.where((u >= 0.05) & (u < 0.1), 1e30, m)
        return torch.from_numpy(m.astype(np.float32)).to(dev)

    d2i, d2o = memos(), memos()
    ct = torch.from_numpy((rng.standard_normal((h, w)) * 2.0**-60).astype(np.float32)).to(dev)
    bwd = (k, 2.0**91, 0.0, 0.0)
    for x, y in zip(band_conv.p2_fused_bwd(ct, d2i, d2o, *bwd), band_conv.p2_fused_bwd_plain(ct, d2i, d2o, *bwd)):
        assert torch.isfinite(y).all() and torch.equal(x, y)
    for d2 in (d2i, d2o):
        assert _sqrt_paths(d2, 0.0) == (True, True)
        assert bool((d2 < 2.0**-126).any()) and bool((d2 > 2.0**100).any())


def test_soft_kernels_take_halo_frames(dev):
    """soft_mm_fwd/bwd on a halo'd frame with a live window (the forward bit
    for bit its plain version, the backward within 1e-4 of the scale), and
    F1/B1 with a live-row window (bit for bit)."""
    rng = np.random.default_rng(21)
    k1, k2, c = soft_mxu.range_stats(66, 2.0, 1.0, (0.0, 255.0))
    g = torch.from_numpy((rng.random((2, 90 + 2 * k2, 75)) * 255).astype(np.float32)).to(dev)
    win = (k2, 90 + k2 + 3, 4, 70)
    f, d2i, d2o = cuda_soft_mm.mm_fused_fwd(g, c, k1, k2, 2.0, 1.0, 1e-6, row_off=k2, h_out=90, window=win)
    for x, y in zip((f, d2i, d2o), cuda_soft_mm.mm_fused_fwd_plain(g, c, k1, k2, 2.0, 1.0, 1e-6, row_off=k2,
                                                                   h_out=90, window=win)):
        assert x.shape == (2, 90, 75) and torch.equal(x, y)
    ct = torch.from_numpy(rng.standard_normal((2, 90 + 2 * k2, 75)).astype(np.float32)).to(dev)
    d2 = [torch.nn.functional.pad(m, (0, 0, k2, k2), value=1e30) for m in (d2i, d2o)]
    got = cuda_soft_mm.mm_fused_bwd(ct, *d2, g[:, k2 : k2 + 90].contiguous(), c, k1, k2, 2.0, 1.0, 1e-6,
                                    row_off=k2, window=(0, 90 + 2 * k2, 4, 70))
    want = cuda_soft_mm.mm_fused_bwd_plain(ct, *d2, g[:, k2 : k2 + 90].contiguous(), c, k1, k2, 2.0, 1.0, 1e-6,
                                           row_off=k2, window=(0, 90 + 2 * k2, 4, 70))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert float(got[..., :4].abs().max()) == 0.0
    x = torch.from_numpy((rng.random((3, 50, 40)) * 4000 - 2000).astype(np.float32)).to(dev)
    s1 = soft_fused.f1_pass(x, 20, 1.0, 0.5, window=(6, 41))
    assert torch.equal(s1, soft_fused.f1_plain(x, 20, 1.0, 0.5, window=(6, 41)))
    assert bool((s1[..., :6, :] == 1e30).all())
    ds1 = torch.from_numpy(rng.standard_normal((3, 2, 50, 40)).astype(np.float32)).to(dev)
    dg = soft_fused.b1_pass(x, s1, ds1, 20, 1.0, 0.5, window=(6, 41))
    assert torch.equal(dg, soft_fused.b1_plain(x, s1, ds1, 20, 1.0, 0.5, window=(6, 41)))
    assert float(dg[..., 41:, :].abs().max()) == 0.0


SOFT_TIERS = {  # (shape, mesh, spread, T, keyword arguments, kernel counters that must move)
    "1a": ((512, 96), ((4,), ("y",)), 6, 1.0, dict(gray_range=(0.0, 255.0)), ("soft_mm_fwd", "soft_mm_bwd")),
    "1a-2d": ((256, 256), ((2, 2), ("y", "x")), 6, 1.0, dict(gray_range=(0.0, 255.0), x_axis="x"),
              ("soft_mm_fwd", "soft_mm_bwd")),
    "1b": ((120, 96), ((4,), ("y",)), 6, 1.0, dict(gray_range=(0.0, 255.0)), ("p2_fused_fwd", "p2_fused_bwd")),
    "1b-wide": ((120, 96), ((4,), ("y",)), 30, 8.0, dict(gray_range=(0.0, 255.0)), ("cols_conv",)),
    "2-window": ((128, 96), ((4,), ("y",)), 6, 1.0, dict(fused_impl="window"), ("soft_f1", "soft_b1")),
    "2-split": ((128, 96), ((4,), ("y",)), 6, 1.0, dict(fused_impl="split"), ("soft_f2", "soft_b2")),
    "3": ((120, 96), ((4,), ("y",)), 6, 1.0, {}, ("softmin_col_fwd", "softmin_col_bwd")),
}


def _one_device_soft(tier, x, spread, t):
    """The single-device twin of a sharded soft tier, on x's device."""
    band = spread + 2
    if tier.startswith("1a") or tier == "1b":
        return cuda_soft_mm.soft_field_mm_fused(x, band, 2.0, t, 1e-6)
    if tier == "1b-wide":
        return softsdf.soft_sdf_field(x, spread, tau=2.0, temperature=t, gray_range=(0.0, 255.0))
    if tier.startswith("2"):
        return soft_fused.soft_sdf_field_fused(x, band, 2.0, t, 1e-6)
    return softsdf.soft_field_cols(x, band, 2.0, t, 1e-6)


@pytest.mark.parametrize("tier", list(SOFT_TIERS))
@pytest.mark.parametrize("impl", ["ppermute", "rdma"])
def test_sharded_soft_tiers_on_logical_shards(dev, tier, impl):
    """Each soft tier over logical shards of the card against its
    single-device twin on the card: the field bit for bit and the gradient
    within 1e-6 of the scale (bit for bit in 1a on a 'y' mesh), but 1b
    (its rows conv a matrix product) within 1e-4 and 1e-4 of the scale by
    the knee rule; the tier's kernels launched."""
    from chaq_sdfgen_tpu_torch.ops import band_conv
    from chaq_sdfgen_tpu_torch.parallel import sharded

    shape, (mshape, names), spread, t, kw, kernels = SOFT_TIERS[tier]
    rng = np.random.default_rng(31)
    # a smooth image in [0, 255] (bilinear noise on an 8-pixel grid): strokes and open space at every radius
    lo = torch.from_numpy(rng.random((1, 1, shape[0] // 8 + 1, shape[1] // 8 + 1)).astype(np.float32))
    g = torch.nn.functional.interpolate(lo, size=shape, mode="bilinear", align_corners=False)[0, 0]
    g = ((g - 0.5) * 1020 + 127.5).clamp(0, 255).to(dev)
    ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    if tier.startswith("1b"):  # the knee rule: no cotangent where |d2| < 1e-3 (ROADMAP Queue 3 item 1)
        k1, k2, c = soft_mxu.range_stats(spread + 2, 2.0, t, (0.0, 255.0))
        _, d2i, d2o = soft_mxu.soft_field_collapsed(g, k1, k2, c, 2.0, t, 1e-6)
        ct = torch.where((d2i.abs() < 1e-3) | (d2o.abs() < 1e-3), torch.zeros((), device=dev), ct)
    counters = {**cuda_soft_mm.LAUNCHES, **band_conv.LAUNCHES, **soft_fused.LAUNCHES, **softmin.LAUNCHES}
    outs = []
    for fn in (lambda x: sharded.sharded_soft_sdf_field(x, spread, _logical(dev, mshape, names), tau=2.0,
                                                        temperature=t, halo=impl, **kw),
               lambda x: _one_device_soft(tier, x, spread, t)):
        x = g.clone().requires_grad_()
        f = fn(x)
        f.backward(ct)
        outs.append((f.detach(), x.grad))
    torch.cuda.synchronize()
    after = {**cuda_soft_mm.LAUNCHES, **band_conv.LAUNCHES, **soft_fused.LAUNCHES, **softmin.LAUNCHES}
    for name in kernels:
        assert after[name] > counters[name], name
    e_f = float((outs[0][0] - outs[1][0]).abs().max())
    e_g = float((outs[0][1] - outs[1][1]).abs().max()) / float(outs[1][1].abs().max())
    if tier.startswith("1b"):
        assert e_f <= 1e-4 and e_g <= 1e-4
    else:
        assert e_f == 0.0 and e_g <= (0.0 if tier == "1a" else 1e-6)
