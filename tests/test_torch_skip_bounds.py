"""The skip rules of two staged kernels, mirrored in NumPy and held against
the plain versions that the kernels match on the card:

  soft_b2 (csrc/soft_fused.cu): per-lane maxima of the d2 memo over 16-row
  segments of the ring (ring position u = source row + band); a warp of 4
  rows takes its reach from the segments its taps cover, and a segment whose
  max leaves every one of its taps below the cut (-27) is skipped. Every tap
  that passes the cut must be visited, so that the sum, d ascending over the
  visited taps, is b2_plain's bit for bit.

  brute_scan_bytes_halo (csrc/brute.cu, brute_scan_staged, a sparse
  block's path): the least plane value per 16-row segment of the frame,
  column and polarity; a pixel walks the segments within the spread
  outward, skips one where a^2 + m^2 >= best and ends a side where a^2 >=
  best. Its integer minimum must be the plain scan's (brute.triangle_d2 on
  the frame). tests/test_torch_scan_bounds.py mirrors the dense blocks'
  capped walk before it.

Each mirror also counts what the kernel visits (taps a pixel), the figure
chip_smoke.py reports on the card.
"""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.ops import brute, cuda_brute, soft_fused

EPS = 1e-6
CUT = np.float32(-27.0)
SEG = 16  # both kernels: rows per segment
WARP_ROWS = 4  # soft_b2: rows per warp and chunk
SHORT = 16  # soft_b2: a reach up to this runs every tap
TILE = 128  # brute_scan_staged: output rows per block


# ------------------------------------------------------------------ soft_b2


def _b2_z(v, dd, target, inv_t):
    """The kernel's exponent ((v - d^2) - target) / T, each step rounded to
    float32."""
    return ((v - np.float32(dd)) - target) * inv_t


def b2_mirror(d2: np.ndarray, s1: np.ndarray, band: int, temperature: float):
    """(visited, passing, iterations) of soft_b2 on one field: d2, s1 (H, W)
    float32. visited and passing are (2 band + 1, H, W) over the taps d =
    -band .. band: the taps the kernel's segment walk reads, and those whose
    exponent passes the cut. iterations counts the tap loop's steps (the
    whole reach where the reaches of all 32 lanes of the warp are at most
    16)."""
    h, w = d2.shape
    inv_t = np.float32(1.0 / temperature)
    n_u = h + 2 * band  # ring positions: source rows -band .. h + band - 1
    n_seg = -(-n_u // SEG)
    ring = np.full((n_seg * SEG, w), -np.inf, np.float32)
    ring[band : band + h] = d2
    segmax = ring.reshape(n_seg, SEG, w).max(axis=1)
    # a warp's bound: the segments its rows' taps cover, u in [4g, 4g + 3 + 2 band]
    o = np.arange(h)
    g0 = (o // WARP_ROWS) * WARP_ROWS
    bnd = np.full((h, w), -np.inf, np.float32)
    for k in range((WARP_ROWS - 1 + 2 * band) // SEG + 2):
        j = g0 // SEG + k
        ok = j <= (g0 + WARP_ROWS - 1 + 2 * band) // SEG
        bnd = np.where(ok[:, None], np.maximum(bnd, segmax[np.minimum(j, n_seg - 1)]), bnd)
    reach = np.zeros((h, w), np.int64)
    for r in range(1, band + 1):
        reach += _b2_z(bnd, r * r, s1, inv_t) >= CUT  # ok(r) falls in r
    visited = np.zeros((2 * band + 1, h, w), bool)
    passing = np.zeros_like(visited)
    seg_steps = np.zeros((h, w), np.int64)
    for i, d in enumerate(range(-band, band + 1)):
        q = o + d
        inside = (q >= 0) & (q < h)
        v = np.where(inside[:, None], d2[np.clip(q, 0, h - 1)], np.float32(-np.inf)).astype(np.float32)
        passing[i] = _b2_z(v, d * d, s1, inv_t) >= CUT
        j = (o + band + d) // SEG
        lo = np.maximum((j * SEG - o - band)[:, None], -reach)
        hi = np.minimum((j * SEG + SEG - 1 - o - band)[:, None], reach)
        dm = np.where((lo <= 0) & (hi >= 0), 0, np.minimum(np.abs(lo), np.abs(hi)))
        live = _b2_z(segmax[j], dm * dm, s1, inv_t) >= CUT
        visited[i] = (abs(d) <= reach) & live
        seg_steps += visited[i]
    # a warp (a row of 32 columns) runs every tap only where all its lanes' reaches are short
    cols = -(-w // 32) * 32
    short = np.pad(reach <= SHORT, ((0, 0), (0, cols - w)), constant_values=True)
    short = np.repeat(short.reshape(h, -1, 32).all(axis=2), 32, axis=1)[:, :w]
    iterations = np.where(short, 2 * reach + 1, seg_steps)
    return visited, passing, iterations


def _gray(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return (rng.random(shape) * 4000 - 2000).astype(np.float32)
    if kind == "far_seed":
        g = np.zeros(shape, np.float32)
        g[..., 1, 2] = 255.0
        return g
    if kind == "mask255":
        return ((rng.random(shape) < 0.05) * 255).astype(np.float32)
    if kind in ("uniform0", "uniform255"):
        return np.full(shape, 0.0 if kind == "uniform0" else 255.0, np.float32)
    raise ValueError(kind)


B2_CASES = [
    # (kind, shape, band, tau, T)
    ("noise", (70, 37), 1, 2.0, 1.0),
    ("noise", (150, 40), 66, 2.0, 1.0),
    ("noise", (130, 33), 112, 1.0, 0.5),
    ("noise", (90, 35), 66, 2.0, 8.0),
    ("far_seed", (150, 36), 66, 2.0, 1.0),
    ("far_seed", (140, 20), 112, 0.25, 0.5),
    ("mask255", (120, 45), 66, 2.0, 1.0),
    ("mask255", (100, 31), 112, 2.0, 8.0),
    ("uniform0", (80, 33), 66, 2.0, 1.0),
    ("uniform255", (80, 33), 66, 2.0, 1.0),
    ("noise", (11, 50), 66, 2.0, 1.0),  # H smaller than a segment
    ("noise", (2, 7, 64), 20, 2.0, 0.5),  # a batch
]


@pytest.mark.parametrize("kind,shape,band,tau,temperature", B2_CASES)
def test_b2_segment_bounds_visit_every_live_tap(kind, shape, band, tau, temperature):
    """Every tap that passes the cut lies in a visited segment, within the
    warp's reach; the sum over the visited taps is b2_plain bit for bit."""
    g = torch.from_numpy(_gray(kind, shape, band))
    s1 = soft_fused.f1_plain(g, band, tau, temperature)
    _, d2 = soft_fused.f2_plain(s1, band, temperature, EPS)
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32))
    want = soft_fused.b2_plain(ct, d2, s1, band, temperature, EPS)
    # g = the tails' VJP, as b2_plain forms it
    d = torch.sqrt(torch.where(d2 > 0, d2, torch.zeros(())) + EPS)
    half = torch.where(d2 > 0, torch.full((), 0.5), torch.zeros(())) / d
    gv = torch.stack([(-ct) * torch.where(d[..., 0, :, :] > 1, half[..., 0, :, :], torch.zeros(())),
                      ct * half[..., 1, :, :]], dim=-3)
    inv_t = float(np.float32(1.0 / temperature))
    d2n, s1n = d2.reshape(-1, *d2.shape[-2:]).numpy(), s1.reshape(-1, *s1.shape[-2:]).numpy()
    gvf, got = gv.reshape(d2n.shape), torch.zeros(d2n.shape)
    h = d2n.shape[-2]
    for f in range(d2n.shape[0]):
        visited, passing, _ = b2_mirror(d2n[f], s1n[f], band, temperature)
        assert not (passing & ~visited).any(), "a tap inside the cut lies in a skipped segment"
        # the kernel's sum: d ascending over the visited taps that pass the cut
        vf, tf = torch.from_numpy(d2n[f]), torch.from_numpy(s1n[f])
        for i, dd in enumerate(range(-band, band + 1)):
            src = torch.arange(h) + dd
            ok = (src >= 0) & (src < h)
            v = torch.where(ok[:, None], vf[src.clamp(0, h - 1)], torch.full((), float("-inf")))
            gg = torch.where(ok[:, None], gvf[f][src.clamp(0, h - 1)], torch.zeros(()))
            z = ((v - float(dd * dd)) - tf) * inv_t
            take = torch.from_numpy(visited[i]) & (z >= -27.0)
            got[f] = got[f] + torch.where(take, torch.exp(z), torch.zeros(())) * gg
    assert torch.equal(got.reshape(want.shape).view(torch.int32), want.view(torch.int32))


def test_b2_segment_bounds_never_loop_longer_than_the_tile_bound():
    """A stroke in +-2040 (windows that mix strokes and empty space), band
    112: the segment walk's loop is per pixel no longer than the previous
    design's, whose reach came from one max of d2 over a 32-column x (64 +
    2 band)-row tile window, and shorter on average on some field."""
    band, tau, t = 112, 1.0, 0.5
    m = np.zeros((256, 64), np.float32)
    m[100:106, 10:50] = 1.0
    s1 = soft_fused.f1_plain(torch.from_numpy(m * 4080 - 2040), band, tau, t)
    _, d2 = soft_fused.f2_plain(s1, band, t, EPS)
    inv_t = np.float32(1.0 / t)
    shorter = False
    for f in range(2):
        d2f, s1f = d2[f].numpy(), s1[f].numpy()
        _, passing, iterations = b2_mirror(d2f, s1f, band, t)
        old = np.zeros(iterations.shape, np.int64)
        for y0 in range(0, 256, 64):
            for x0 in (0, 32):
                hi = d2f[max(0, y0 - band) : y0 + 64 + band, x0 : x0 + 32].max()
                reach = np.zeros((64, 32), np.int64)
                for r in range(1, band + 1):
                    reach += _b2_z(hi, r * r, s1f[y0 : y0 + 64, x0 : x0 + 32], inv_t) >= CUT
                old[y0 : y0 + 64, x0 : x0 + 32] = 2 * reach + 1
        assert (iterations <= old).all() and (iterations >= passing.sum(axis=0)).all()
        shorter = shorter or iterations.mean() < old.mean()
    assert shorter


# ------------------------------------------------------------------- BRUTE


def brute_mirror(b: np.ndarray, strips: np.ndarray, spread: int, row_off: int):
    """(best, taps) of brute_scan_staged's segment walk: b (n, h, w) bool, strips (2, 4,
    n, hs, w) ints, the shard's rows at [row_off, row_off + h). best is the
    integer minimum of dx^2 + dy^2 per pixel, taps the rows each pixel read.
    The segments are the frame's 16-row ones (each block's window is
    widened to whole segments)."""
    n, h, w = b.shape
    hs = strips.shape[-2]
    planes = strips.astype(np.int64)
    ii, yy, xx = np.arange(n)[:, None, None], np.arange(h)[None, :, None], np.arange(w)[None, None, :]
    val = b.astype(np.int64)  # the planes each pixel reads: polarity 1 where it is set
    c = yy + row_off + np.zeros_like(val)  # frame rows

    def tap(r, a):
        p = planes[val, :, ii, np.clip(r, 0, hs - 1), xx]  # (..., 4): L1, L2, R1, R2
        dl = np.where(p[..., 0] != a, p[..., 0], p[..., 1])
        dr = np.where(p[..., 2] != a, p[..., 2], p[..., 3])
        return np.minimum(dl, dr) ** 2 + a * a

    bt = tap(c, 0)
    nseg = -(-hs // SEG)
    m = np.full((2, n, nseg * SEG, w), 1 << 40, np.int64)
    m[:, :, :hs] = planes.min(axis=1)
    segm = m.reshape(2, n, nseg, SEG, w).min(axis=3)  # (2, n, nseg, w)
    cnt = np.ones_like(bt)
    lo, hi = np.maximum(c - spread, 0), np.minimum(c + spread, hs - 1)
    su, sd = c // SEG, c // SEG
    up, dn = (bt > 1) & (c > lo), (bt > 1) & (c < hi)
    while (up | dn).any():
        for side in ("up", "dn"):
            on = up if side == "up" else dn
            s = su if side == "up" else sd
            if side == "up":
                top, bot = np.maximum(s * SEG, lo), np.minimum(s * SEG + SEG - 1, c - 1)
                a0 = c - bot
            else:
                top, bot = np.maximum(s * SEG, c + 1), np.minimum(s * SEG + SEG - 1, hi)
                a0 = top - c
            mm = segm[val, ii, np.clip(s, 0, nseg - 1), xx]
            rows = on & (bot >= top)
            stop = rows & (a0 * a0 >= bt)
            on = on & ~stop
            live = rows & ~stop & (a0 * a0 + mm * mm < bt)
            for i in range(SEG):
                r = bot - i if side == "up" else top + i
                act = live & (r >= top if side == "up" else r <= bot)
                a = np.abs(c - r)
                brk = act & (a * a >= bt)
                on, live, act = on & ~brk, live & ~brk, act & ~brk
                bt = np.where(act, np.minimum(bt, tap(r, a)), bt)
                cnt += act
            if side == "up":
                up, su = on & (s * SEG > lo), su - 1
            else:
                dn, sd = on & (s * SEG + SEG - 1 < hi), sd + 1
    return bt, cnt


def _plain_best(b: torch.Tensor, strips: torch.Tensor, spread: int, row_off: int) -> np.ndarray:
    """The plain scan's integer minimum on the shard's rows (what
    brute_scan_bytes_halo_plain feeds its tail)."""
    h, hs = b.shape[-2], strips.shape[-2]
    ext = torch.nn.functional.pad(b.view(torch.uint8), (0, 0, row_off, hs - h - row_off)) != 0
    return brute.triangle_d2(ext, strips, spread)[..., row_off : row_off + h, :].numpy()


def _mask(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "glyph":  # sparse strokes: most pixels far from the other polarity
        m = np.zeros(shape, bool)
        m[..., 5:9, 3:30] = True
        m[..., -20:-16, -12:-2] = True
        return m
    if kind == "noise":
        return rng.random(shape) < 0.3
    if kind == "far_seed":
        m = np.zeros(shape, bool)
        m[..., 1, 2] = True
        return m
    if kind in ("uniform0", "uniform1"):
        return np.full(shape, kind == "uniform1")
    raise ValueError(kind)


BRUTE_CASES = [
    # (kind, (n, h, w), spread, (rows above, rows below))
    ("glyph", (1, 150, 45), 20, (20, 20)),  # two tiles, shard frame
    ("glyph", (1, 140, 33), 64, (64, 64)),
    ("noise", (2, 60, 37), 10, (10, 10)),
    ("far_seed", (1, 130, 40), 40, (0, 40)),
    ("far_seed", (1, 50, 31), 300, (300, 300)),  # uint16 planes
    ("uniform0", (1, 40, 35), 16, (16, 16)),
    ("uniform1", (1, 40, 35), 16, (16, 16)),
    ("glyph", (1, 11, 50), 20, (25, 30)),  # H smaller than a segment, hr > spread
    ("noise", (1, 70, 29), 5, (12, 9)),  # hr > spread
    ("glyph", (1, 100, 40), 12, (0, 0)),  # one device: row_off 0, hs = h
]


@pytest.mark.parametrize("kind,shape,spread,halo", BRUTE_CASES)
def test_brute_segment_minima_keep_the_integer_minimum(kind, shape, spread, halo):
    """The segment walk's integer minimum is the plain scan's on every pixel,
    and its bytes are brute_scan_bytes_halo_plain's."""
    top, bottom = halo
    n, h, w = shape
    full = _mask(kind, (n, top + h + bottom, w), spread)
    strips = cuda_brute.seed_strips_plain(torch.from_numpy(full), spread)
    b = torch.from_numpy(full[:, top : top + h].copy())
    best, taps = brute_mirror(b.numpy(), strips.numpy(), spread, top)
    want = _plain_best(b, strips, spread, top)
    np.testing.assert_array_equal(best, want)
    got = brute.brute_tail(torch.from_numpy(best).to(torch.int32), b, spread, False, False)
    assert torch.equal(got, cuda_brute.brute_scan_bytes_halo_plain(b, strips, spread, top))
    assert taps.min() >= 1


def test_brute_segment_minima_hold_on_any_planes():
    """On random planes (L2 < L1 allowed, as the GPU test's planes are) the
    least of all four planes still bounds every tap."""
    rng = np.random.default_rng(3)
    spread, n, h, w, top, bottom = 30, 2, 40, 37, 30, 12
    strips = torch.from_numpy(rng.integers(0, spread + 2, size=(2, 4, n, top + h + bottom, w), dtype=np.uint8))
    b = torch.from_numpy(rng.random((n, h, w)) < 0.4)
    best, _ = brute_mirror(b.numpy(), strips.numpy(), spread, top)
    np.testing.assert_array_equal(best, _plain_best(b, strips, spread, top))


def test_brute_segment_minima_end_the_walk_on_the_background():
    """Far from any seed of the other polarity, a pixel reads its own row
    and no other: every segment's least value is spread + 1."""
    spread = 64
    full = _mask("glyph", (1, 300, 64), 0)
    strips = cuda_brute.seed_strips_plain(torch.from_numpy(full), spread)
    b = full[:, spread : 300 - spread].copy()
    _, taps = brute_mirror(b, strips.numpy(), spread, spread)
    # rows whose reach meets no segment of the strokes (frame rows 5-9 and
    # 280-283): shard rows 20-139 (frame rows 84-203)
    far = np.zeros_like(b)
    far[:, 20:140] = True
    assert (taps[far] == 1).all()
