"""The bounds of two row and column scans, mirrored in NumPy and held against
the plain versions that the kernels match on the card:

  brute_scan_bytes and brute_scan_bytes_halo (csrc/brute.cu,
  brute_scan_staged): a block of 32 columns x 128 rows counts its set
  pixels. A sparse or uniform block (under 1/8 or over 7/8 set) stages its
  window and walks by segments from each pixel's own row. A dense block
  first walks |dy| = 0, 1, ..., K per pixel (stopping once dy^2 >= its
  minimum or past the spread and the frame); if all its pixels are done it
  stages no more, else its open pixels go on by segments from |dy| = K + 1.
  The segment walk: the least plane value per 16-row segment of the frame,
  column and polarity; a segment where a^2 + m^2 >= best is skipped, a side
  ends where a^2 >= best. The integer minimum must be the plain scan's
  (brute.triangle_d2).

  soft_f1 (csrc/soft_fused.cu): a block stages a row tile's heights with
  each 32-position segment's least height; a warp (32 pixels) takes its
  hard-min stop and reach from the least of its taps, runs every tap where
  all 32 reaches are at most 16, else goes segment by segment and takes a
  segment's taps only out to the last |d| whose exponent, formed from the
  segment's least height, passes the cut (-27). Every tap that passes the
  cut must be visited, so that the sum, d ascending over the visited taps,
  is f1_plain's bit for bit.

Each mirror also counts what the kernel does (rows read or taps looped a
pixel, blocks staged), the figures chip_smoke.py reports on the card.
"""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.ops import brute, cuda_brute, soft_fused

CUT = np.float32(-27.0)
SEG = 16  # BRUTE: frame rows per segment
COLS, ROWS = 32, 128  # BRUTE: a block's columns and output rows
F1_SEG, F1_TILE, SHORT = 32, 4096, 16  # F1: positions per segment, pixels per tile, short reach


# ------------------------------------------------------------------- BRUTE


def dense_blocks(b: np.ndarray) -> np.ndarray:
    """(n, blocks down, blocks across) bool: the blocks of 32 columns x 128
    rows with between 1/8 and 7/8 of their pixels set."""
    n, h, w = b.shape
    bh, bw = -(-h // ROWS), -(-w // COLS)
    pad = ((0, 0), (0, bh * ROWS - h), (0, bw * COLS - w))
    ones = np.pad(b, pad).reshape(n, bh, ROWS, bw, COLS).sum(axis=(2, 4))
    npix = np.pad(np.ones_like(b), pad).reshape(n, bh, ROWS, bw, COLS).sum(axis=(2, 4))
    return (8 * ones >= npix) & (8 * ones <= 7 * npix)


def per_pixel(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """A (n, blocks down, blocks across) array spread over the blocks' pixels."""
    return np.repeat(np.repeat(blocks, ROWS, axis=1), COLS, axis=2)[:, :h, :w]


def capped_mirror(b: np.ndarray, strips: np.ndarray, spread: int, row_off: int, cap: int):
    """(best, rows, staged) of brute_scan_staged: b (n, h, w) bool, strips
    (2, 4, n, hs, w) ints, the pixels' rows at [row_off, row_off + h) of the
    frame. best: the integer minimum of dx^2 + dy^2 per pixel; rows: the
    rows each pixel read; staged: (n, blocks down, blocks across) bool, the
    blocks that staged their whole window."""
    n, h, w = b.shape
    hs = strips.shape[-2]
    planes = strips.astype(np.int64)
    ii, yy, xx = np.arange(n)[:, None, None], np.arange(h)[None, :, None], np.arange(w)[None, None, :]
    val = b.astype(np.int64)  # the planes each pixel reads: polarity 1 where it is set
    c = yy + row_off + np.zeros_like(val)

    def tap(r, a):
        p = planes[val, :, ii, np.clip(r, 0, hs - 1), xx]  # (..., 4): L1, L2, R1, R2
        dl = np.where(p[..., 0] != a, p[..., 0], p[..., 1])
        dr = np.where(p[..., 2] != a, p[..., 2], p[..., 3])
        return np.minimum(dl, dr) ** 2 + a * a

    # a dense block's capped walk; a sparse one's pixels go to the segments from |dy| = 1
    dense = dense_blocks(b)
    k = np.where(per_pixel(dense, h, w), cap, 0)
    best = tap(c, 0)
    rows = np.ones_like(best)
    reach = np.minimum(spread, np.maximum(c, hs - 1 - c))
    open_ = np.ones(best.shape, bool)
    for a in range(1, cap + 2):
        open_ &= ~((a * a >= best) | (a > reach))
        walking = open_ & (a <= k)
        if not walking.any():
            break
        for r in (c - a, c + a):
            on = walking & (r >= 0) & (r < hs)
            best = np.where(on, np.minimum(best, tap(r, a)), best)
            rows += on
    # a sparse block always stages; a dense one where a pixel is left
    bh, bw = -(-h // ROWS), -(-w // COLS)
    left = np.pad(open_, ((0, 0), (0, bh * ROWS - h), (0, bw * COLS - w)))
    staged = ~dense | left.reshape(n, bh, ROWS, bw, COLS).any(axis=(2, 4))

    # the segment walk of the open pixels from |dy| = cap + 1 (the window's
    # segments are the frame's: each window is widened to whole segments)
    nseg = -(-hs // SEG)
    m = np.full((2, n, nseg * SEG, w), 1 << 40, np.int64)
    m[:, :, :hs] = planes.min(axis=1)
    segm = m.reshape(2, n, nseg, SEG, w).min(axis=3)
    lo, hi = np.maximum(c - spread, 0), np.minimum(c + spread, hs - 1)
    ub, db = c - k - 1, c + k + 1
    su, sd = np.maximum(ub, 0) // SEG, db // SEG
    up, dn = open_ & (ub >= lo), open_ & (db <= hi)
    while (up | dn).any():
        for side in ("up", "dn"):
            on = up if side == "up" else dn
            s = su if side == "up" else sd
            if side == "up":
                top, bot = np.maximum(s * SEG, lo), np.minimum(s * SEG + SEG - 1, ub)
                a0 = c - bot
            else:
                top, bot = np.maximum(s * SEG, db), np.minimum(s * SEG + SEG - 1, hi)
                a0 = top - c
            mm = segm[val, ii, np.clip(s, 0, nseg - 1), xx]
            stop = on & (a0 * a0 >= best)
            on = on & ~stop
            live = on & (a0 * a0 + mm * mm < best)
            for i in range(SEG):
                r = bot - i if side == "up" else top + i
                act = live & (r >= top if side == "up" else r <= bot)
                a = np.abs(c - r)
                brk = act & (a * a >= best)
                on, live, act = on & ~brk, live & ~brk, act & ~brk
                best = np.where(act, np.minimum(best, tap(r, a)), best)
                rows += act
            if side == "up":
                up, su = on & (s * SEG > lo), su - 1
            else:
                dn, sd = on & (s * SEG + SEG - 1 < hi), sd + 1
    return best, rows, staged


def pixel_walk_rows(b: np.ndarray, strips: np.ndarray, spread: int) -> np.ndarray:
    """The rows each pixel's per-pixel walk reads (brute_scan_pixel_kernel)."""
    n, h, w = b.shape
    planes = strips.astype(np.int64)
    ii, yy, xx = np.arange(n)[:, None, None], np.arange(h)[None, :, None], np.arange(w)[None, None, :]
    val = b.astype(np.int64)
    c = yy + np.zeros_like(val)

    def tap(r, a):
        p = planes[val, :, ii, np.clip(r, 0, h - 1), xx]
        dl = np.where(p[..., 0] != a, p[..., 0], p[..., 1])
        dr = np.where(p[..., 2] != a, p[..., 2], p[..., 3])
        return np.minimum(dl, dr) ** 2 + a * a

    best, rows = tap(c, 0), np.ones(b.shape, np.int64)
    reach = np.minimum(spread, np.maximum(c, h - 1 - c))
    on = np.ones(b.shape, bool)
    for a in range(1, spread + 1):
        on &= (a * a < best) & (a <= reach)
        for r in (c - a, c + a):
            step = on & (r >= 0) & (r < h)
            best = np.where(step, np.minimum(best, tap(r, a)), best)
            rows += step
    return rows


def _mask(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "glyph":  # sparse strokes: most pixels far from the other polarity
        m = np.zeros(shape, bool)
        m[..., 5:9, 3:30] = True
        m[..., -20:-16, -12:-2] = True
        m[..., shape[-2] // 2 : shape[-2] // 2 + 3, shape[-1] // 3] = True
        return m
    if kind == "noise":
        return rng.random(shape) < 0.5
    if kind == "one_seed":
        m = np.zeros(shape, bool)
        m[..., 1, 2] = True
        return m
    if kind in ("uniform0", "uniform1"):
        return np.full(shape, kind == "uniform1")
    raise ValueError(kind)


BRUTE_CASES = [
    # (kind, (n, h, w), spread, K)
    ("glyph", (1, 300, 70), 64, 8),  # 3 block rows, 3 block columns (the last partial)
    ("glyph", (1, 150, 45), 64, 0),
    ("glyph", (1, 200, 33), 5, 1),
    ("glyph", (1, 140, 40), 300, 16),  # uint16 planes
    ("noise", (1, 130, 37), 1, 8),
    ("noise", (1, 260, 64), 64, 8),
    ("noise", (1, 140, 50), 64, 0),
    ("noise", (3, 140, 40), 5, 2),  # a batch of 3
    ("one_seed", (1, 140, 40), 64, 8),
    ("one_seed", (1, 60, 31), 300, 8),
    ("one_seed", (1, 50, 20), 5, 400),  # K past the spread: the walk alone
    ("uniform0", (1, 40, 35), 16, 8),
    ("uniform1", (1, 40, 35), 16, 1),
]


@pytest.mark.parametrize("kind,shape,spread,cap", BRUTE_CASES)
def test_capped_walk_keeps_the_integer_minimum(kind, shape, spread, cap):
    """The capped walk and the segment walk after it give the plain scan's
    integer minimum on every pixel and brute_scan_bytes_plain's bytes, and
    read no more rows in all than the per-pixel walk."""
    m = torch.from_numpy(_mask(kind, shape, spread + cap))
    strips = cuda_brute.seed_strips_plain(m, spread)
    best, rows, _ = capped_mirror(m.numpy(), strips.numpy(), spread, 0, cap)
    np.testing.assert_array_equal(best, brute.triangle_d2(m, strips, spread).numpy())
    got = brute.brute_tail(torch.from_numpy(best).to(torch.int32), m, spread, False, False)
    assert torch.equal(got, cuda_brute.brute_scan_bytes_plain(m, strips, spread))
    # the per-pixel walk (dy^2 >= best its only stop) reads more rows in all
    assert rows.sum() <= pixel_walk_rows(m.numpy(), strips.numpy(), spread).sum()


def test_capped_walk_on_a_0_255_mask():
    """A 0/255 uint8 mask (as_mask: nonzero is set) through the mirror and
    the plain scan."""
    m255 = (_mask("glyph", (1, 200, 50), 0).astype(np.uint8) * 255)
    m = torch.from_numpy(m255) != 0
    strips = cuda_brute.seed_strips_plain(torch.from_numpy(m255), 64)
    best, _, _ = capped_mirror(m.numpy(), strips.numpy(), 64, 0, 8)
    got = brute.brute_tail(torch.from_numpy(best).to(torch.int32), m, 64, False, False)
    assert torch.equal(got, cuda_brute.brute_scan_bytes_plain(torch.from_numpy(m255), strips, 64))


@pytest.mark.parametrize("spread,halo,cap", [(20, (20, 20), 8), (64, (64, 0), 2), (12, (25, 30), 0)])
def test_capped_walk_on_halo_frames(spread, halo, cap):
    """The kernel takes a row offset into a frame: the mirror on a shard's
    frame gives the plain halo scan's minimum."""
    top, bottom = halo
    full = _mask("glyph", (1, top + 150 + bottom, 45), spread) | _mask("noise", (1, top + 150 + bottom, 45), 1) & (
        np.arange(45) > 40)
    strips = cuda_brute.seed_strips_plain(torch.from_numpy(full), spread)
    b = full[:, top : top + 150].copy()
    best, _, _ = capped_mirror(b, strips.numpy(), spread, top, cap)
    ext = torch.nn.functional.pad(torch.from_numpy(b).view(torch.uint8), (0, 0, top, bottom)) != 0
    want = brute.triangle_d2(ext, strips, spread)[..., top : top + 150, :].numpy()
    np.testing.assert_array_equal(best, want)


def test_capped_walk_holds_on_any_planes():
    """On random planes (L2 < L1 allowed, as the GPU tests' planes are) the
    capped walk and the least of all four planes still give the minimum."""
    rng = np.random.default_rng(3)
    spread, n, h, w = 30, 2, 150, 37
    strips = torch.from_numpy(rng.integers(0, spread + 2, size=(2, 4, n, h, w), dtype=np.uint8))
    b = torch.from_numpy(rng.random((n, h, w)) < 0.4)
    for cap in (0, 3):
        best, _, _ = capped_mirror(b.numpy(), strips.numpy(), spread, 0, cap)
        np.testing.assert_array_equal(best, brute.triangle_d2(b, strips, spread).numpy())


def test_blocks_stage_only_where_a_walk_is_left():
    """Dense content ends every walk within K: no block stages. A lone seed
    makes every block sparse: all stage, and far from the seed a pixel reads
    its own row and no segment's. Half set, half clear (dense blocks on the
    border, sparse ones away from it): the dense blocks stage for the pixels
    more than K rows from the border."""
    spread, cap = 64, 8
    check = np.indices((1, 256, 64)).sum(axis=0) % 2 == 0  # a checkerboard: every best is 1
    _, _, staged = capped_mirror(check, cuda_brute.seed_strips_plain(torch.from_numpy(check), spread).numpy(),
                                 spread, 0, cap)
    assert not staged.any()
    lone = _mask("one_seed", (1, 400, 64), 0)
    best, rows, staged = capped_mirror(lone, cuda_brute.seed_strips_plain(torch.from_numpy(lone), spread).numpy(),
                                       spread, 0, cap)
    assert staged.all()
    far = np.zeros_like(lone)
    far[:, 2 + spread + SEG :] = True  # no row of the seed's segment within the spread
    assert (best[far] > spread * spread).all() and (rows[far] == 1).all()
    half = np.zeros((1, 512, 64), bool)
    half[:, 192:] = True  # the border inside the second block row
    assert dense_blocks(half).tolist() == [[[False, False], [True, True], [False, False], [False, False]]]
    best, rows, staged = capped_mirror(half, cuda_brute.seed_strips_plain(torch.from_numpy(half), spread).numpy(),
                                       spread, 0, cap)
    np.testing.assert_array_equal(best, brute.triangle_d2(torch.from_numpy(half), cuda_brute.seed_strips_plain(
        torch.from_numpy(half), spread), spread).numpy())
    assert staged.all()
    assert rows[:, 192 - cap : 192 + cap].max() <= 1 + 2 * cap  # within K of the border: the capped walk alone


# ---------------------------------------------------------------------- F1


def reach_of(gap: np.ndarray, band: int, inv_t: np.float32) -> np.ndarray:
    """Per element, the largest r in [0, band] whose exponent bound (gap -
    r^2) / T passes the cut (0 where none does): as the kernels' loop counts
    it, from a float32 estimate corrected step by step."""
    ok = lambda r: ((gap - (r * r).astype(np.float32)) * inv_t) >= CUT
    r = np.floor(np.sqrt(np.clip(gap.astype(np.float64) - CUT / inv_t, 0, band * band))).astype(np.int64)
    while (down := (r > 0) & ~ok(r)).any():
        r -= down
    while (up := (r < band) & ok(r + 1)).any():
        r += up
    return r


def f1_mirror(v: np.ndarray, band: int, temperature: float):
    """(m, visited, passing, iterations, old_iterations) of soft_f1 on one
    field's heights v (H, W) float32: m the hard min; visited and passing
    (2 band + 1, H, W) over the taps d = -band .. band, the taps the kernel
    reads and those whose exponent passes the cut; iterations the tap loop's
    steps per pixel (2 reach + 1 where all 32 reaches of the warp are at
    most 16, else the visited taps) and old_iterations the loop of the design
    before it, 2 reach + 1 with the reach from the least height over a
    256-pixel block's span."""
    h, w = v.shape
    inv_t = np.float32(1.0 / temperature)
    pad = -(-band // F1_SEG) * F1_SEG
    d_idx = np.arange(-band, band + 1)[:, None, None]
    dd = (d_idx * d_idx).astype(np.float32)
    out = [np.zeros((h, w), np.float32), np.zeros((2 * band + 1, h, w), bool), np.zeros((2 * band + 1, h, w), bool),
           np.zeros((h, w), np.int64), np.zeros((h, w), np.int64)]
    for x0 in range(0, w, F1_TILE):
        lt = min(F1_TILE, w - x0)
        nst = -(-lt // F1_SEG) * F1_SEG + 2 * pad
        st = np.full((h, nst), np.inf, np.float32)  # staged position j holds x = x0 - pad + j
        lo, hi = max(0, x0 - pad), min(w, x0 - pad + nst)
        st[:, lo - (x0 - pad) : hi - (x0 - pad)] = v[:, lo:hi]
        segm = st.reshape(h, nst // F1_SEG, F1_SEG).min(axis=2)
        j = pad + np.arange(lt)
        # the least of each warp's taps, staged positions [ws, ws + 32 + 2 band)
        vmin = np.repeat(np.stack([st[:, pad + k - band : pad + k + F1_SEG + band].min(axis=1)
                                   for k in range(0, lt, F1_SEG)], axis=1), F1_SEG, axis=1)[:, :lt]
        taps = np.stack([st[:, j + d] for d in range(-band, band + 1)])  # (2 band + 1, h, lt)
        m = (taps + dd).min(axis=0)
        gap = m - vmin
        reach = reach_of(gap, band, inv_t)
        z = ((m[None] - taps) - dd) * inv_t
        passing = z >= CUT
        # the warp's path: every tap where its 32 reaches are short
        cols = -(-lt // 32) * 32
        short = np.pad(reach <= SHORT, ((0, 0), (0, cols - lt)), constant_values=True)
        short = np.repeat(short.reshape(h, -1, 32).all(axis=2), 32, axis=1)[:, :lt]
        # else a segment's taps out to its own reach from its least height
        sg = (j[None, :] + d_idx) // F1_SEG
        top = m[None] - np.take_along_axis(segm[None], np.broadcast_to(sg, (2 * band + 1, 1, lt)), axis=2)
        rs = reach_of(top, band, inv_t)
        inreach = np.abs(d_idx) <= reach[None]
        visited = inreach & (short[None] | (np.abs(d_idx) <= rs))
        # the design before: the least height over the 256-pixel block's span
        old_vmin = np.repeat(np.stack([v[:, max(0, x0 + b0 - band) : x0 + b0 + 256 + band].min(axis=1)
                                       for b0 in range(0, lt, 256)], axis=1), 256, axis=1)[:, :lt]
        old_reach = reach_of(m - old_vmin, band, inv_t)
        cut = slice(x0, x0 + lt)
        out[0][:, cut], out[1][:, :, cut], out[2][:, :, cut] = m, visited, passing
        out[3][:, cut] = np.where(short, 2 * reach + 1, visited.sum(axis=0))
        out[4][:, cut] = 2 * old_reach + 1
    return tuple(out)


def _gray(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return (rng.random(shape) * 255).astype(np.float32)
    if kind == "pm2000":
        return (rng.random(shape) * 4000 - 2000).astype(np.float32)
    if kind == "glyph":  # strokes in +-2040: windows that mix strokes and empty space
        m = np.zeros(shape, np.float32)
        for y in range(0, shape[-2], 7):
            x = int(rng.integers(0, shape[-1]))
            m[..., y : y + 3, x : x + int(rng.integers(3, 12))] = 1.0
        return m * 4080 - 2040
    raise ValueError(kind)


def _mirror_s1(gray: torch.Tensor, band: int, tau: float, temperature: float, above: bool, window=None):
    """S1 (..., 2, H, W) from the mirror: m - T log(sum), the sum d ascending
    over the visited taps that pass the cut, as the kernel forms it; and the
    mirror's counts for each field."""
    scale, t, inv_t = soft_fused._scalars(tau, temperature, above)
    hts = soft_fused._heights(soft_fused._logits(gray, scale), t)
    flat = hts.reshape(-1, *hts.shape[-2:])
    s1, counts = torch.empty_like(flat), []
    for f in range(flat.shape[0]):
        m, visited, passing, iters, old = f1_mirror(flat[f].numpy(), band, t)
        assert not (passing & ~visited).any(), "a tap inside the cut is not visited"
        counts.append((iters, old, passing.sum(axis=0)))
        v = torch.nn.functional.pad(flat[f], (band, band), value=float("inf"))
        mt, s = torch.from_numpy(m), torch.zeros(flat.shape[-2:])
        for i, d in enumerate(range(-band, band + 1)):
            z = ((mt - v[:, band + d : band + d + flat.shape[-1]]) - float(d * d)) * inv_t
            s = s + torch.where(torch.from_numpy(visited[i]) & (z >= -27.0), torch.exp(z), 0.0)
        s1[f] = mt - t * torch.log(s)
    s1 = s1.reshape(hts.shape)
    live = soft_fused._live_rows(gray.shape[-2], window, gray.device)
    return (s1 if live is None else torch.where(live, s1, torch.full((), soft_fused.PAD_H))), counts


F1_CASES = [
    # (kind, shape, band, tau, T, test_above)
    ("u8", (20, 150), 10, 2.0, 1.0, True),
    ("u8", (12, 300), 66, 1.0, 0.5, False),
    ("pm2000", (16, 200), 66, 2.0, 1.0, True),
    ("pm2000", (10, 260), 112, 1.0, 0.5, True),
    ("pm2000", (2, 4200), 66, 2.0, 1.0, False),  # two row tiles
    ("glyph", (24, 330), 66, 2.0, 1.0, True),
    ("glyph", (16, 300), 112, 1.0, 0.5, False),
    ("glyph", (14, 257), 10, 1.0, 0.5, True),
    ("u8", (2, 5, 70), 112, 2.0, 1.0, True),  # a batch, narrower than the band
    ("pm2000", (7, 1), 66, 2.0, 1.0, True),
    ("u8", (1, 17), 0, 2.0, 1.0, True),
]


@pytest.mark.parametrize("kind,shape,band,tau,temperature,above", F1_CASES)
def test_f1_segment_bounds_visit_every_live_tap(kind, shape, band, tau, temperature, above):
    """Every tap that passes the cut is visited; the sum over the visited
    taps gives f1_plain bit for bit."""
    g = torch.from_numpy(_gray(kind, shape, band))
    got, _ = _mirror_s1(g, band, tau, temperature, above)
    want = soft_fused.f1_plain(g, band, tau, temperature, above)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_f1_segment_bounds_with_a_live_row_window():
    """Rows outside the live window are 1e30, as f1_plain writes them."""
    g = torch.from_numpy(_gray("glyph", (30, 200), 4))
    got, _ = _mirror_s1(g, 66, 2.0, 1.0, True, (6, 25))
    assert torch.equal(got.view(torch.int32), soft_fused.f1_plain(g, 66, 2.0, 1.0, True, (6, 25)).view(torch.int32))


@pytest.mark.parametrize("band,tau,temperature", [(66, 2.0, 1.0), (112, 1.0, 0.5)])
def test_f1_segment_bounds_never_loop_longer_than_the_block_bound(band, tau, temperature):
    """Per pixel the loop is no longer than the design before it (a reach
    from the least height over a 256 + 2 band span) and no shorter than the
    live taps; on strokes in +-2040 it is shorter on average."""
    g = torch.from_numpy(_gray("glyph", (20, 600), 9))
    _, counts = _mirror_s1(g, band, tau, temperature, True)
    for iters, old, live in counts:
        assert (iters <= old).all() and (iters >= live).all()
    assert counts[0][0].mean() < 0.8 * counts[0][1].mean()  # the in-field: strokes at height 0 in ~1e3
