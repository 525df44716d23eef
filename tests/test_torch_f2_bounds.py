"""Two redesigned kernels' schedules, mirrored in NumPy and held against the
plain versions that the kernels match on the card:

  soft_f2 (csrc/soft_fused.cu): a block owns 32 columns x 96 rows and, per
  field, stages its window (96 + 2 band rows) in 16-row segments with each
  segment's least S1 per lane (column). A warp takes 12 consecutive rows; a
  lane's bound is the least S1 over its own taps for those rows (the rows of
  the partial segments at the ends one by one, the whole segments between
  from their minima: the least over exactly those rows). The bound stops the
  hard min's centre-out walk (once bound + d^2 >= m) and sets the reach, a
  float32 estimate corrected to the loop's integer; the warp's lanes step
  together over d = -R .. R, R the longest reach of the warp's 32 lanes in
  that row. Every tap that passes the cut (-27) must be visited, so that the
  sums, d ascending over the visited taps, give f2_plain's field and memos
  bit for bit; every output is written once, by a warp whose taps lie in
  the window its block staged.

  soft_mm_fwd and soft_mm_bwd (csrc/soft_mm.cu): one strip walker, mirrored
  by tests/test_torch_b1_bounds.py's mm_strip_mirror. A block
  owns 128 output columns and a strip of rows (the launcher's strips: about
  one block per SM slot), turns 16-row batches of its input (gray forward;
  the cotangent and memos backward) into the two fields' conv inputs, runs
  the rows conv into a ring of 3 batches and 16-row chunks of the cols conv
  into the epilogue. Every output pixel must be written once, every ring row
  a chunk reads must hold the batch it needs, and the tiled sums must be the
  plain convs' bit for bit, on halo frames with row offsets and live
  windows; the forward's tails over them give mm_fused_fwd_plain bit for bit
  (tolerance 0: the same torch operations on the CPU, element by element).

Each mirror also counts what the kernel does (taps looped, hard-min walk
steps), the figures chip_smoke.py reports on the card.
"""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.ops import cuda_soft_mm, soft_fused, soft_mxu
from test_torch_b1_bounds import mm_strip_mirror

CUT = np.float32(-27.0)
SEG, TILE_ROWS, WARP_ROWS = 16, 96, 12  # F2: rows a segment, a block's rows, a warp's consecutive rows
PARENT_ROWS = 64  # F2 before: a block's rows
EPS = 1e-6


# ---------------------------------------------------------------------- F2


def reach_of(gap, bound, inv_t):
    """Per element the largest r in [0, bound] whose exponent bound (gap -
    r^2) / T passes the cut (0 where none does), as the kernels' reach_of
    finds it: a float estimate corrected step by step to the loop's
    integer."""
    gap = np.asarray(gap, np.float32)
    bound = np.broadcast_to(np.asarray(bound, np.int64), gap.shape)
    with np.errstate(invalid="ignore", over="ignore"):
        ok = lambda r: ((gap - (r * r).astype(np.float32)) * inv_t) >= CUT  # noqa: E731
        est = np.nan_to_num(gap.astype(np.float64), nan=0.0, posinf=1e9, neginf=0.0) - CUT / inv_t
        r = np.minimum(np.floor(np.sqrt(np.clip(est, 0, 1e9))), bound).astype(np.int64)
        while (down := (r > 0) & ~ok(r)).any():
            r -= down
        while (up := (r < bound) & ok(r + 1)).any():
            r += up
    return r


def f2_mirror(v: np.ndarray, band: int, temperature: float) -> dict:
    """soft_f2's schedule on one field's S1 ``v`` (H, W) float32: m (the
    hard min), visited and passing ((2 band + 1, H, W) over d = -band ..
    band: the taps the kernel's sum reads, those whose exponent passes the
    cut), walk (the hard-min walk's steps), loop (the warp's steps in the
    sum), and parent_loop and parent_walk (the design before it: the reach
    and the walk's stop from the least S1 over its 32 x (64 + 2 band) block
    window, a warp stepping to its longest reach)."""
    h, w = v.shape
    inv_t = np.float32(1.0 / temperature)
    d_idx = np.arange(-band, band + 1)[:, None, None]
    dd = (d_idx * d_idx).astype(np.float32)
    vp = np.pad(v, ((band, band + WARP_ROWS), (0, 0)), constant_values=np.inf)  # row y at y + band
    o = np.arange(h)
    taps = np.stack([vp[o + band + d] for d in range(-band, band + 1)])
    # a lane's bound: the least of its warp's taps, rows [ow - band, ow + nw - 1 + band]
    ow = (o // WARP_ROWS) * WARP_ROWS
    nw = np.minimum(WARP_ROWS, h - ow)
    vmin = np.stack([vp[a : a + n + 2 * band].min(axis=0) for a, n in zip(ow, nw)])
    m = (taps + dd).min(axis=0)  # the walk's stop is exact: it finds the least tap + d^2
    walk = np.zeros((h, w), np.int64)
    for d in range(1, band + 1):
        walk += (vmin + np.float32(d * d)) < m  # vmin + d^2 rises in d: the steps before the stop
    reach = reach_of(m - vmin, band, inv_t)
    with np.errstate(invalid="ignore"):
        passing = ((m[None] - taps) - dd) * inv_t >= CUT
    cols = -(-w // 32) * 32  # a warp: 32 lanes (columns) of one row; a lane past W has reach 0

    def per_warp(a):  # each pixel's warp's longest
        return np.repeat(np.pad(a, ((0, 0), (0, cols - w))).reshape(h, -1, 32).max(axis=2), 32, axis=1)[:, :w]

    warp_reach = per_warp(reach)
    visited = np.abs(d_idx) <= warp_reach[None]
    # the design before: a block-wide min over 32 columns x rows [y0 - band, y0 + 64 + band)
    lo = np.empty((h, w), np.float32)
    vx = np.pad(v, ((0, 0), (0, cols - w)), constant_values=np.inf)
    for y0 in range(0, h, PARENT_ROWS):
        blk = vx[max(0, y0 - band) : y0 + PARENT_ROWS + band].reshape(-1, cols // 32, 32).min(axis=(0, 2))
        lo[y0 : y0 + PARENT_ROWS] = np.repeat(blk, 32)[:w]
    parent = per_warp(reach_of(m - lo, band, inv_t))
    parent_walk = sum(((lo + np.float32(d * d)) < m).astype(np.int64) for d in range(1, band + 1))
    return dict(m=m, visited=visited, passing=passing, walk=walk, loop=2 * warp_reach + 1,
                parent_loop=2 * parent + 1, parent_walk=parent_walk)


def f2_from_mirror(s1: torch.Tensor, band: int, temperature: float):
    """(field, d2, schedules) from the mirror: d2 = m - T log(sum), the sum d
    ascending over the visited taps that pass the cut, as the kernel forms
    it; then f2_plain's tails."""
    _, t, inv_t = soft_fused._scalars(1.0, temperature)
    flat = s1.reshape(-1, *s1.shape[-2:])
    d2, scheds = torch.empty_like(flat), []
    h, w = flat.shape[-2:]
    for f in range(flat.shape[0]):
        sc = f2_mirror(flat[f].numpy(), band, t)
        assert not (sc["passing"] & ~sc["visited"]).any(), "a tap inside the cut is not visited"
        scheds.append(sc)
        vp = torch.nn.functional.pad(flat[f], (0, 0, band, band), value=float("inf"))
        m, s = torch.from_numpy(sc["m"]), torch.zeros((h, w))
        for i, d in enumerate(range(-band, band + 1)):
            z = ((m - vp[band + d : band + d + h]) - float(d * d)) * inv_t
            s = s + torch.where(torch.from_numpy(sc["visited"][i]) & (z >= -27.0), torch.exp(z), 0.0)
        d2[f] = m - t * torch.log(s)
    d2 = d2.reshape(s1.shape)
    d_in, d_out = soft_fused._dist(d2, EPS).unbind(-3)
    field = d_out - torch.where(d_in > 1, d_in - 1.0, torch.zeros(()))
    return field, d2, scheds


def _gray(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return (rng.random(shape) * 255).astype(np.float32)
    if kind == "pm2000":
        return (rng.random(shape) * 4000 - 2000).astype(np.float32)
    if kind == "glyph":  # strokes in +-2040, sparse down the columns: long reaches between them
        m = np.zeros(shape, np.float32)
        for y in range(int(rng.integers(0, 20)), shape[-2], 37):
            x = int(rng.integers(0, shape[-1]))
            m[..., y : y + 3, x : x + int(rng.integers(3, 20))] = 1.0
        return m * 4080 - 2040
    raise ValueError(kind)


def _s1(kind, shape, band, tau, temperature, seed=0):
    return soft_fused.f1_plain(torch.from_numpy(_gray(kind, shape, seed + band)), band, tau, temperature)


F2_CASES = [
    # (kind, shape, band, tau, T)
    ("pm2000", (40, 70), 66, 2.0, 1.0),
    ("u8", (37, 45), 0, 2.0, 1.0),
    ("pm2000", (50, 33), 1, 1.0, 0.5),
    ("glyph", (150, 70), 66, 2.0, 1.0),
    ("glyph", (130, 40), 112, 1.0, 0.5),
    ("pm2000", (100, 65), 112, 1.0, 0.5),
    ("glyph", (90, 50), 20, 2.0, 8.0),
    ("u8", (2, 45, 40), 20, 2.0, 1.0),  # a batch
    ("pm2000", (17, 1), 66, 2.0, 1.0),
    ("u8", (1, 17), 10, 2.0, 1.0),
]


@pytest.mark.parametrize("kind,shape,band,tau,temperature", F2_CASES)
def test_f2_lane_bounds_visit_every_live_tap(kind, shape, band, tau, temperature):
    """Every tap that passes the cut is visited; the field and memos from
    the visited taps are f2_plain's bit for bit."""
    s1 = _s1(kind, shape, band, tau, temperature)
    field, d2, _ = f2_from_mirror(s1, band, temperature)
    want_f, want_d2 = soft_fused.f2_plain(s1, band, temperature, EPS)
    assert torch.equal(field.view(torch.int32), want_f.view(torch.int32))
    assert torch.equal(d2.view(torch.int32), want_d2.view(torch.int32))


@pytest.mark.parametrize("band,temperature", [(66, 1.0), (112, 0.5)])
def test_f2_lane_bounds_never_loop_longer_than_the_block_bound(band, temperature):
    """Per warp the loop is no longer than the design before it (a reach
    from the least S1 of a 32-column x (64 + 2 band)-row window) and per
    pixel no shorter than the live taps; on strokes in +-2040 the in-field's
    loop and hard-min walk are shorter on average."""
    s1 = _s1("glyph", (200, 96), band, 2.0, temperature, seed=9)
    _, _, scheds = f2_from_mirror(s1, band, temperature)
    for sc in scheds:
        assert (sc["loop"] <= sc["parent_loop"]).all() and (sc["loop"] >= sc["passing"].sum(axis=0)).all()
        assert (sc["walk"] <= sc["parent_walk"]).all() and (sc["walk"] <= band).all()
    assert scheds[0]["loop"].mean() < scheds[0]["parent_loop"].mean()
    assert scheds[0]["walk"].mean() < scheds[0]["parent_walk"].mean()


@pytest.mark.parametrize("band", [10, 66])
def test_f2_lane_bounds_on_a_halo_block(band):
    """Tier 2's halo'd S1 block (pass2_ext: a shard's S1 with band rows of
    its neighbours', 1e30 beyond the image): the mirror gives f2_plain on
    the block bit for bit, and its interior the whole image's field."""
    s1 = _s1("glyph", (120, 40), band, 2.0, 1.0, seed=3)
    whole = soft_fused.f2_plain(s1, band, 1.0, EPS, memos=False)
    pad = torch.full_like(s1[..., :band, :], soft_fused.PAD_H)
    s1ext = torch.cat([pad, s1[..., :40 + band, :]], dim=-2)  # shard 0 of 3: the top edge
    field, d2, _ = f2_from_mirror(s1ext, band, 1.0)
    want_f, want_d2 = soft_fused.f2_plain(s1ext, band, 1.0, EPS)
    assert torch.equal(field.view(torch.int32), want_f.view(torch.int32))
    assert torch.equal(d2.view(torch.int32), want_d2.view(torch.int32))
    assert torch.equal(field[band : band + 40].view(torch.int32), whole[:40].view(torch.int32))


def f2_tile_schedule(h: int, band: int) -> np.ndarray:
    """Walks every 96-row tile of one column block as the kernel does: segs
    segments of 16 window rows (window row r = image row y0 - band + r) and
    warp w's rows 12 w .. 12 w + 11; asserts that every tap of a warp's rows
    and every row of its bound lie in the staged window; returns how often
    each row is written."""
    segs = (TILE_ROWS + 2 * band + SEG - 1) // SEG
    written = np.zeros(h, np.int64)
    for y0 in range(0, h, TILE_ROWS):
        for w in range(TILE_ROWS // WARP_ROWS):
            ow, nw = w * WARP_ROWS, min(WARP_ROWS, h - y0 - w * WARP_ROWS)
            if nw <= 0:
                continue
            assert 0 <= ow and ow + nw - 1 + 2 * band < segs * SEG, "a warp's taps leave the staged window"
            written[y0 + ow : y0 + ow + nw] += 1
    return written


@pytest.mark.parametrize("h,band", [(4096, 66), (4096, 112), (300, 56), (300, 57), (1000, 0), (777, 1), (17, 66),
                                    (95, 5), (97, 112)])
def test_f2_tiles_write_every_row_once_from_the_staged_window(h, band):
    """Every output row is written once, by a warp whose taps lie in the
    window its block staged (96 + 2 band rows filling 13 segments exactly at
    band 56, with a partial one at 57)."""
    assert (f2_tile_schedule(h, band) == 1).all()


# ------------------------------------------------------ the two-conv strips

def _occupancy_frame(shape_in, k1, k2, window, tau, temperature, seed):
    """gray on a frame and the forward producer's output: the occupancies,
    zero outside the live window (as mm_fused_fwd_plain forms them)."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy((rng.random(shape_in) * 255).astype(np.float32))
    _, _, c = soft_mxu.range_stats(2 * max(k1, k2), tau, temperature, (0.0, 255.0))
    _, e_in, e_out = soft_mxu.occupancy(g, tau, temperature, c, True)
    live = cuda_soft_mm._live(window, shape_in[-2], shape_in[-1], 0, "cpu")
    if live is not None:
        e_in, e_out = torch.where(live, e_in, 0.0), torch.where(live, e_out, 0.0)
    return g, c, e_in, e_out


MM_FWD_CASES = [
    # (shape_in, k1, k2, row_off, h_out, window, tau, T, sms, per_sm)
    ((40, 300), 10, 10, 0, 40, None, 2.0, 1.0, 132, 2),  # one device, several column tiles
    ((70, 129), 16, 1, 0, 70, None, 1.0, 0.5, 1, 1),  # strips of the whole height, a 1-column last tile
    ((2, 50, 140), 3, 16, 0, 50, None, 2.0, 1.0, 4, 1),  # a batch, strips of 16-row chunks
    ((33 + 20, 150), 10, 10, 10, 33, (10, 53, 0, 150), 2.0, 1.0, 8, 1),  # shard 0's frame: rows above dead
    ((40 + 32, 160 + 32), 16, 16, 16, 40, (0, 72, 16, 192), 2.0, 1.0, 2, 2),  # a 2-D tile at the left edge
    ((40 + 2, 200), 0, 1, 1, 40, (0, 41, 0, 137), 3.0, 1.0, 3, 2),  # the bottom-right edge, tau not 2^k
    ((17, 1), 5, 7, 0, 17, None, 2.0, 1.0, 132, 2),
]


@pytest.mark.parametrize("shape_in,k1,k2,row_off,h_out,window,tau,temperature,sms,per_sm", MM_FWD_CASES)
def test_mm_fwd_strips_write_every_pixel_once_from_produced_rows(shape_in, k1, k2, row_off, h_out, window,
                                                                tau, temperature, sms, per_sm):
    """The forward on the shared walker: every output pixel written once
    from ring rows that hold their batch; its tails over the tiled sums are
    mm_fused_fwd_plain's field and memos bit for bit on the same frame."""
    win = (0, shape_in[-2], 0, shape_in[-1]) if window is None else window
    g, c, e_in, e_out = _occupancy_frame(shape_in, k1, k2, win, tau, temperature, seed=k1 + k2 + h_out)
    (s_in, s_out), written = mm_strip_mirror(e_in, e_out, k1, k2, row_off, h_out, temperature, sms, per_sm)
    assert bool((written == 1).all())
    got = soft_mxu.tails(s_in, s_out, temperature, c, EPS)
    want = cuda_soft_mm.mm_fused_fwd_plain(g, c, k1, k2, tau, temperature, EPS, row_off=row_off, h_out=h_out,
                                           window=window)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_mm_bwd_sums_through_the_shared_walker():
    """The backward's producer output (the tails' VJP on a shard's frame,
    row_off k2) through the same walker mirror: the plain transposed convs
    bit for bit."""
    k1, k2, h_out, w = 10, 10, 33, 150
    frame = (h_out + 2 * k2, w)
    w1, w2 = soft_mxu.tap_weights(k1, 1.0), soft_mxu.tap_weights(k2, 1.0)
    _, c, e_in, e_out = _occupancy_frame(frame, k1, k2, (0, frame[0], 0, w), 2.0, 1.0, seed=6)
    _, d2_in, d2_out = soft_mxu.tails(*(soft_mxu.conv_cols(soft_mxu.conv_rows(e, w1), w2) for e in (e_in, e_out)),
                                      1.0, c, EPS)
    ct = torch.from_numpy(np.random.default_rng(5).standard_normal(frame).astype(np.float32))
    ds_in, ds_out = soft_mxu.tails_vjp(ct, d2_in, d2_out, 1.0, c, EPS)
    (a, b), written = mm_strip_mirror(ds_in, ds_out, k1, k2, k2, h_out, 1.0, 8, 1)
    assert bool((written == 1).all())
    for got, ds in ((a, ds_in), (b, ds_out)):
        want = soft_mxu.conv_cols(soft_mxu.conv_rows(ds, w1), w2, k2, h_out)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
