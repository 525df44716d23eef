"""Two backward kernels' schedules, mirrored in NumPy and held against the
plain versions that the kernels match on the card:

  soft_b1 (csrc/soft_fused.cu): a block stages a row tile's (up to 2048
  pixels) S1 and dS1 of both fields with each 32-position segment's
  greatest S1; a warp (32 pixels) takes the greatest of its taps per field
  and, against the least height of its lanes, the last |d| whose exponent
  ((vmax - d^2) - h) / T passes the cut (-27), -1 where tap 0 fails; its
  lanes step together over d = -reach .. reach. Every tap that passes the
  cut must be visited, so that each field's sum, d ascending over the
  visited taps, gives b1_plain bit for bit; and the warp's steps never
  exceed those of the design before it (a block-wide max of S1 over 256 +
  2 band positions against each lane's own height).

  soft_mm_bwd (csrc/soft_mm.cu; its strip walker serves soft_mm_fwd too,
  tests/test_torch_f2_bounds.py): a block owns 128 output columns and a
  strip of rows (the launcher's strips: about one block per SM slot), walks
  it 16 output rows a chunk, and keeps the rows conv of 16-row batches in a
  ring of 3 batches. Every output pixel must be written once, every ring row
  a chunk reads must hold the batch it needs, and the tiled sums must be the
  plain convs' bit for bit, for the frames and windows the sharded tier
  passes.

Each mirror also counts what the kernel does (taps looped, warp steps), the
figures chip_smoke.py reports on the card.
"""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.ops import cuda_soft_mm, soft_fused, soft_mxu

CUT = np.float32(-27.0)
SEG, TILE, SHORT = 32, 2048, 16  # B1: positions per segment, pixels per tile, short reach


# ---------------------------------------------------------------------- B1


def b1_reach(top, target, bound, inv_t):
    """Per element, the last r in [0, bound] whose exponent bound ((top -
    r^2) - target) / T passes the cut, -1 where r = 0 fails it: as the
    kernel finds it, from a float32 estimate corrected step by step."""
    top, target = np.broadcast_arrays(np.float32(top), np.float32(target))
    bound = np.broadcast_to(bound, top.shape)
    with np.errstate(invalid="ignore", over="ignore"):
        ok = lambda r: (((top - (r * r).astype(np.float32)) - target) * inv_t) >= CUT
        est = np.sqrt(np.clip(np.nan_to_num(top.astype(np.float64) - target, nan=0.0, posinf=1e9, neginf=0.0)
                              - CUT / inv_t, 0, 1e9))
        r = np.minimum(np.floor(est), np.maximum(bound, 0)).astype(np.int64)
        while (down := (r > 0) & ~ok(r)).any():
            r -= down
        while (up := (r < bound) & ok(r + 1)).any():
            r += up
        return np.where(ok(np.zeros_like(r)), r, -1)


def warp_reduce(a, w, fn, fill):
    """Per (row, 32-pixel warp) reduction of a (H, W), pixels past W absent."""
    cols = -(-w // 32) * 32
    return fn(np.pad(a, ((0, 0), (0, cols - w)), constant_values=fill).reshape(a.shape[0], -1, 32), axis=2)


def b1_field(v, target, band, inv_t):
    """One field's (H, W) S1 ``v`` against its heights ``target``: (reach,
    passing, parent_reach). reach (H, W), the warp's (spread over its
    pixels): from the greatest of its taps against its least height, -1
    for no taps; passing (2 band + 1, H, W) over d = -band .. band, the taps
    inside the cut; parent_reach the reach of the design before (each
    pixel's own height against the block-wide max, from 0)."""
    h, w = v.shape
    pad = -(-band // SEG) * SEG
    d_idx = np.arange(-band, band + 1)[:, None, None]
    dd = (d_idx * d_idx).astype(np.float32)
    reach = np.empty((h, w), np.int64)
    parent = np.empty((h, w), np.int64)
    passing = np.zeros((2 * band + 1, h, w), bool)
    for x0 in range(0, w, TILE):
        lt = min(TILE, w - x0)
        nst = -(-lt // SEG) * SEG + 2 * pad
        st = np.full((h, nst), -np.inf, np.float32)  # staged position j holds x = x0 - pad + j
        lo, hi = max(0, x0 - pad), min(w, x0 - pad + nst)
        st[:, lo - (x0 - pad) : hi - (x0 - pad)] = v[:, lo:hi]
        j = pad + np.arange(lt)
        vmax = np.stack([st[:, pad + k - band : pad + k + SEG + band].max(axis=1) for k in range(0, lt, SEG)], axis=1)
        tg = target[:, x0 : x0 + lt]
        r = b1_reach(vmax, warp_reduce(tg, lt, np.min, np.inf), band, inv_t)
        reach[:, x0 : x0 + lt] = np.repeat(r, SEG, axis=1)[:, :lt]
        taps = np.stack([st[:, j + d] for d in range(-band, band + 1)])
        with np.errstate(invalid="ignore"):
            passing[:, :, x0 : x0 + lt] = ((taps - dd) - tg[None]) * inv_t >= CUT
    for b0 in range(0, w, 256):  # the parent's 256-pixel blocks
        hi_b = v[:, max(0, b0 - band) : b0 + 256 + band].max(axis=1, keepdims=True)
        par = b1_reach(np.broadcast_to(hi_b, (h, min(256, w - b0))), target[:, b0 : b0 + 256], band, inv_t)
        parent[:, b0 : b0 + 256] = np.maximum(par, 0)
    return reach, passing, parent


def b1_mirror(gray, s1, ds1, band, tau, temperature, above, window=None):
    """dgray from the mirror (the sums d ascending over the visited taps, then
    b1_plain's height and threshold VJP), and per image the counts, summed
    over fields: live, loop (taps looped a pixel) and warp_steps /
    parent_steps (32 x the sum over warps of their steps: the kernel's warp
    steps together, the parent's lanes each to its own reach, so its warp
    steps its longest)."""
    scale, t, inv_t = soft_fused._scalars(tau, temperature, above)
    l = soft_fused._logits(gray, scale)
    hts = soft_fused._heights(l, t)
    lead = gray.shape[:-2]
    hf, s1f, gf = (x.reshape(-1, 2, *gray.shape[-2:]) for x in (hts, s1, ds1))
    dh = torch.empty_like(hf)
    counts = []
    h, w = gray.shape[-2:]
    d_idx = np.abs(np.arange(-band, band + 1))[:, None, None]
    for n in range(hf.shape[0]):
        c = {"live": 0, "loop": 0, "warp_steps": 0, "parent_steps": 0}
        for f in range(2):
            reach, passing, parent = b1_field(s1f[n, f].numpy(), hf[n, f].numpy(), band, np.float32(inv_t))
            vis = d_idx <= reach[None]
            assert not (passing & ~vis).any(), "a tap inside the cut is not visited"
            steps = np.maximum(2 * reach + 1, 0)
            c["live"] += int(passing.sum())
            c["loop"] += int(steps.sum())
            c["warp_steps"] += 32 * int(warp_reduce(steps, w, np.max, 0).sum())
            c["parent_steps"] += 32 * int(warp_reduce(2 * parent + 1, w, np.max, 0).sum())
            v = torch.nn.functional.pad(s1f[n, f], (band, band), value=float("-inf"))
            g = torch.nn.functional.pad(gf[n, f], (band, band))
            s = torch.zeros((h, w))
            for i, d in enumerate(range(-band, band + 1)):
                z = ((v[:, band + d : band + d + w] - float(d * d)) - hf[n, f]) * inv_t
                s = s + torch.where(torch.from_numpy(vis[i]),
                                    torch.where(z >= -27.0, torch.exp(z), 0.0) * g[:, band + d : band + d + w], 0.0)
            dh[n, f] = s
        counts.append(c)
    dh = dh.reshape(hts.shape)
    one = torch.ones(())
    sig = one / (one + torch.exp(torch.stack([l, -l], dim=-3)))
    dl = torch.where(hts < soft_fused.PAD_H, (dh * -t) * sig, torch.zeros(()))
    dgray = dl[..., 0, :, :] * scale + dl[..., 1, :, :] * -scale
    live = soft_fused._live_rows(gray.shape[-2], window, gray.device)
    dgray = dgray if live is None else torch.where(live, dgray, torch.zeros(()))
    assert dgray.shape == lead + gray.shape[-2:]
    return dgray, counts


def _gray(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return (rng.random(shape) * 255).astype(np.float32)
    if kind == "pm2000":
        return (rng.random(shape) * 4000 - 2000).astype(np.float32)
    if kind == "glyph":  # strokes in +-2040: windows that mix strokes and empty space
        m = np.zeros(shape, np.float32)
        for y in range(0, shape[-2], 5):
            x = int(rng.integers(0, shape[-1]))
            m[..., y : y + 3, x : x + int(rng.integers(3, 12))] = 1.0
        return m * 4080 - 2040
    raise ValueError(kind)


def _case(kind, shape, band, tau, temperature, above, seed=0):
    g = torch.from_numpy(_gray(kind, shape, seed + band))
    s1 = soft_fused.f1_plain(g, band, tau, temperature, above)
    ds1 = torch.from_numpy(np.random.default_rng(seed).standard_normal(tuple(s1.shape)).astype(np.float32))
    return g, s1, ds1


B1_CASES = [
    # (kind, shape, band, tau, T, test_above)
    ("u8", (12, 150), 5, 2.0, 1.0, True),
    ("u8", (8, 300), 66, 1.0, 0.5, False),
    ("pm2000", (12, 200), 66, 2.0, 1.0, True),
    ("pm2000", (6, 260), 112, 1.0, 0.5, True),
    ("pm2000", (2, 4200), 66, 2.0, 1.0, False),  # three row tiles
    ("glyph", (16, 330), 66, 2.0, 1.0, True),
    ("glyph", (10, 300), 112, 1.0, 0.5, False),
    ("glyph", (2, 2100), 5, 1.0, 0.5, True),  # two row tiles
    ("u8", (2, 5, 70), 112, 2.0, 1.0, True),  # a batch, narrower than the band
    ("pm2000", (7, 1), 66, 2.0, 1.0, True),
    ("u8", (1, 17), 0, 2.0, 1.0, True),
    ("glyph", (9, 200), 0, 2.0, 1.0, False),
]


@pytest.mark.parametrize("kind,shape,band,tau,temperature,above", B1_CASES)
def test_b1_warp_bounds_visit_every_live_tap(kind, shape, band, tau, temperature, above):
    """Every tap that passes the cut is visited; the sums over the visited
    taps give b1_plain bit for bit; no warp steps more than the parent's."""
    g, s1, ds1 = _case(kind, shape, band, tau, temperature, above)
    got, counts = b1_mirror(g, s1, ds1, band, tau, temperature, above)
    want = soft_fused.b1_plain(g, s1, ds1, band, tau, temperature, above)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for c in counts:
        assert c["live"] <= c["loop"] <= c["warp_steps"] <= c["parent_steps"]


@pytest.mark.parametrize("window", [(3, 20), (0, 7), (15, 30)])
def test_b1_warp_bounds_with_a_live_row_window(window):
    """Rows outside the live window take a zero dgray, as b1_plain writes."""
    g, s1, ds1 = _case("glyph", (24, 180), 66, 2.0, 1.0, True, seed=4)
    got, _ = b1_mirror(g, s1, ds1, 66, 2.0, 1.0, True, window)
    want = soft_fused.b1_plain(g, s1, ds1, 66, 2.0, 1.0, True, window)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("temperature", [1.0, 0.5, 8.0])
def test_b1_warp_reach_is_its_lanes_longest(temperature):
    """The kernel takes a warp's reach from its least height: the exponent
    bound falls as the height grows (rounding is monotone), so that reach is
    the largest of the lanes' own reaches, -1 exactly where no lane's tap 0
    passes, whatever the heights (clipped ones included)."""
    rng = np.random.default_rng(int(temperature * 10))
    inv_t = np.float32(1.0 / temperature)
    vmax = np.repeat((rng.random((400, 1)) * 3000 - 500).astype(np.float32), 32, axis=1)
    hts = (rng.random((400, 32)) * 3000).astype(np.float32)
    hts[rng.random((400, 32)) < 0.05] = np.float32(soft_fused.PAD_H)
    lanes = b1_reach(vmax, hts, 112, inv_t)
    warp = b1_reach(vmax[:, :1], hts.min(axis=1, keepdims=True), 112, inv_t)
    assert (warp[:, 0] == lanes.max(axis=1)).all()
    assert (warp[:, 0] >= 0).any() and (warp[:, 0] < 0).any()


# ------------------------------------------------------------- soft_mm_bwd

COLS, ROWS, RING = 128, 16, 3  # output columns a block, rows a batch and a chunk, batches in the ring


def mm_strip(h_out, w, n, sms, per_sm):
    """The launcher's strip height (both declared kernels, launch_strips):
    whole 16-row chunks, about one block per SM slot in all."""
    cols, chunks = -(-w // COLS) * n, -(-h_out // ROWS)
    strips = min(max(sms * per_sm // cols, 1), chunks)
    return -(-chunks // strips) * ROWS


def mm_strip_mirror(ds_in, ds_out, k1, k2, row_off, h_out, temperature, sms=132, per_sm=2):
    """The two convs (..., h_out, W) as the strip walker's blocks compute
    them from the producer's output of both fields (..., h_in, W): the
    tails' VJP ds backward, the occupancies forward, zero outside the live
    window. Per block the batches of 16 input rows (the block's 128 columns
    and k1 more each side, zero outside the frame) through the rows conv into
    a ring of 3 batches, per chunk of 16 output rows the cols conv from the
    ring. Asserts that every ring row a chunk reads holds its batch, and
    returns the sums and how often each output pixel was written."""
    w1, w2 = soft_mxu.tap_weights(k1, temperature), soft_mxu.tap_weights(k2, temperature)
    lead, (h_in, w) = ds_in.shape[:-2], ds_in.shape[-2:]
    src = [x.reshape(-1, h_in, w) for x in (ds_in, ds_out)]
    nimg = src[0].shape[0]
    strip = mm_strip(h_out, w, nimg, sms, per_sm)
    out = [torch.zeros(nimg, h_out, w) for _ in range(2)]
    written = torch.zeros(nimg, h_out, w, dtype=torch.int32)
    for z in range(nimg):
        padded = [torch.nn.functional.pad(s[z], (k1 + COLS, k1 + COLS)) for s in src]
        for x0 in range(0, w, COLS):
            for o_start in range(0, h_out, strip):
                o_end = min(o_start + strip, h_out)
                y_base = o_start + row_off - k2
                batches = -(-(o_end - o_start + 2 * k2) // ROWS)
                ring = [None] * RING
                b = 0
                for t0 in range(0, o_end - o_start, ROWS):
                    need = min((t0 + ROWS - 1 + 2 * k2) // ROWS, batches - 1)
                    while b <= need:
                        rows = []
                        for f in range(2):
                            p = torch.zeros(ROWS, COLS + 2 * k1)
                            for r in range(ROWS):
                                y = y_base + ROWS * b + r
                                if 0 <= y < h_in:
                                    p[r] = padded[f][y, x0 + COLS : x0 + 2 * COLS + 2 * k1]
                            acc = torch.zeros(ROWS, COLS)
                            for i, wi in enumerate(w1):
                                acc = acc + wi * p[:, i : i + COLS]
                            rows.append(acc)
                        ring[b % RING] = (b, rows)
                        b += 1
                    for t in range(t0, min(t0 + ROWS, o_end - o_start)):
                        for f in range(2):
                            acc = torch.zeros(COLS)
                            for i, wi in enumerate(w2):
                                u = t + i
                                held, rows = ring[(u // ROWS) % RING]
                                assert held == u // ROWS, "a chunk reads a ring row its batch does not hold"
                                acc = acc + wi * rows[f][u % ROWS]
                            lim = min(COLS, w - x0)
                            out[f][z, o_start + t, x0 : x0 + lim] = acc[:lim]
                        written[z, o_start + t, x0 : x0 + min(COLS, w - x0)] += 1
    return [o.reshape(lead + (h_out, w)) for o in out], written


def _frame_ds(shape_in, k1, k2, window, seed):
    """ds of both fields on a frame (cuda_soft_mm.mm_fused_bwd_plain's first
    step: the tails' VJP, zero outside the window)."""
    rng = np.random.default_rng(seed)
    _, _, c = soft_mxu.range_stats(66, 2.0, 1.0, (0.0, 255.0))
    gfr = torch.from_numpy((rng.random(shape_in) * 255).astype(np.float32))
    _, d2i, d2o = cuda_soft_mm.mm_fused_fwd_plain(gfr, c, k1, k2, 2.0, 1.0, 1e-6)
    ct = torch.from_numpy(rng.standard_normal(shape_in).astype(np.float32))
    ds_in, ds_out = soft_mxu.tails_vjp(ct, d2i, d2o, 1.0, c, 1e-6)
    live = cuda_soft_mm._live(window, shape_in[-2], shape_in[-1], 0, "cpu")
    if live is not None:
        ds_in, ds_out = torch.where(live, ds_in, 0.0), torch.where(live, ds_out, 0.0)
    return ds_in, ds_out


MM_CASES = [
    # (shape_in, k1, k2, row_off, h_out, window, sms, per_sm)
    ((40, 300), 10, 10, 0, 40, None, 132, 2),  # one device, several column tiles
    ((70, 129), 16, 1, 0, 70, None, 1, 1),  # strips of the whole height, a 1-column last tile
    ((2, 50, 140), 3, 16, 0, 50, None, 4, 1),  # a batch, strips of 16-row chunks
    ((33 + 20, 150), 10, 10, 10, 33, (0, 53, 0, 150), 8, 1),  # a shard's frame, row_off k2
    ((40 + 32, 160 + 32), 16, 16, 16, 40, (0, 72, 16, 192), 2, 2),  # a 2-D tile at the left edge
    ((40 + 2, 200), 0, 1, 1, 40, (0, 42, 0, 137), 3, 2),  # the right edge's live columns
    ((1, 17), 0, 0, 0, 1, None, 132, 2),
    ((17, 1), 5, 7, 0, 17, None, 132, 2),
]


@pytest.mark.parametrize("shape_in,k1,k2,row_off,h_out,window,sms,per_sm", MM_CASES)
def test_mm_bwd_tiles_write_every_pixel_once_from_produced_rows(shape_in, k1, k2, row_off, h_out, window, sms,
                                                                per_sm):
    """Every output pixel is written once, every ring row a chunk reads is
    produced and still held, and the tiled convs equal the plain convs bit
    for bit (the frames and windows of parallel/sharded.py: row_off k2,
    h_in = h_out + 2 k2, edge windows)."""
    win = (0, shape_in[-2], 0, shape_in[-1]) if window is None else window
    ds_in, ds_out = _frame_ds(shape_in, k1, k2, win, seed=k1 + k2 + h_out)
    got, written = mm_strip_mirror(ds_in, ds_out, k1, k2, row_off, h_out, 1.0, sms, per_sm)
    assert bool((written == 1).all())
    w1, w2 = soft_mxu.tap_weights(k1, 1.0), soft_mxu.tap_weights(k2, 1.0)
    for g, ds in zip(got, (ds_in, ds_out)):
        want = soft_mxu.conv_cols(soft_mxu.conv_rows(ds, w1), w2, row_off, h_out)
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))


def test_mm_bwd_strips_fill_the_card_once():
    """At 4096^2 on an H100 (132 SMs, 2 blocks an SM) the launcher cuts 8
    strips of 512 rows: 256 blocks, one wave, 2 k2 halo rows a strip."""
    assert mm_strip(4096, 4096, 1, 132, 2) == 512
    assert mm_strip(4096, 4096, 8, 132, 2) == 4096
    assert mm_strip(17, 300, 3, 132, 2) == 16
