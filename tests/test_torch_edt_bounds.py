"""The walks of the hard EXACT pass 2 and of the exact distance field
(csrc/edt.cu), mirrored in NumPy and held bit for bit against the plain
versions that the kernels match on the card:

  edt_band_bytes (edt_band_staged): a block of 32 columns x 128 output rows
  stages the core of both strips (its rows within K = 8 of its output rows)
  and counts its near pixels (both fields' own row values at most K). A
  dense block (at least 7/8 near) walks |dy| = 1 .. min(K, band) per pixel
  and field; if every pixel is done it stages no more. Otherwise the block
  stages its window and keeps per column, field and 16-row segment of the
  strip the least clipped value m (|v| for int32). Each open field walks
  the segments outward from |dy| = 1 (sparse block) or min(K, band) + 1,
  skips a segment where fl(fl(m m) + fl(a a)) >= best, and ends a side at
  fl(a a) >= best or past the band. Past a block's shared memory
  (staged_fits) every pixel walks dy = 1, 2, ... instead. All in
  float32 with the plain version's rounding: g = fl(min(d, clip)^2), a tap
  fl(g + fl(dy^2)).

  edt_dist (edt_dist_core, then edt_dist_staged on the tiles it leaves):
  a tile of 32 columns x 128 rows stages its core, a dense tile (7/8 of its
  own values at most K) walks |dy| <= K per pixel, and every tile writes
  the least min(d, sat) of each of its 16-row segments into the table and
  a flag where a pixel is left; the pixels left test segments outward over
  the whole column (int32), reading a segment's rows from the tile's window
  (64 rows each side of its rows) or, beyond it, from device memory.

Each mirror counts what the kernel does (rows read and segments tested a
pixel, the path each block takes), the figures chip_smoke.py reports on the
card, and returns the minimum each pixel reaches.
"""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.ops import cuda_edt, edt, merge
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt

SEG, COLS, ROWS, CAP, CHUNK, DIST_HALO = 16, 32, 128, 8, 4, 64
# a block's dynamic shared memory on the H100: the opt-in 227 KB less
# edt_band_staged's 64 B of static shared memory
SMEM = 232448 - 64


def staged_fits(h: int, band: int, itemsize: int) -> bool:
    """Whether edt_band_bytes's launcher stages on the H100: a block's
    largest window, min(h, 128 + 2 band + 30) rows of 32 columns of both
    strips plus a float32 per column, field and 16-row segment, fits SMEM
    (on the card, cuda_edt.pass2_staged asks the launcher itself)."""
    rows = min(h, ROWS + 2 * min(band, h) + 2 * (SEG - 1))
    return (rows * itemsize + -(-rows // SEG) * 4) * 2 * COLS <= SMEM


def sq(a) -> np.ndarray:
    """fl(a^2) of integer |dy| values."""
    f = np.asarray(a).astype(np.float32)
    return f * f


def g_of(v, clip: int) -> np.ndarray:
    """fl(min(v, clip)^2): the plain version's clipped square."""
    d = np.minimum(np.asarray(v, np.int64), clip).astype(np.float32)
    return d * d


def blocks_of(mask: np.ndarray) -> np.ndarray:
    """(n, blocks down, blocks across) counts of a (n, rows, w) bool over
    blocks of 128 rows x 32 columns."""
    n, h, w = mask.shape
    bh, bw = -(-h // ROWS), -(-w // COLS)
    return np.pad(mask, ((0, 0), (0, bh * ROWS - h), (0, bw * COLS - w))).reshape(n, bh, ROWS, bw, COLS).sum(
        axis=(2, 4))


def per_pixel(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.repeat(np.repeat(blocks, ROWS, axis=1), COLS, axis=2)[:, :h, :w]


def dense_blocks(near: np.ndarray) -> np.ndarray:
    """A block is dense where at least 7/8 of its pixels are near."""
    return 8 * blocks_of(near) >= 7 * blocks_of(np.ones_like(near))


class Counts:
    def __init__(self, shape):
        self.rows = np.zeros(shape, np.int64)  # rows read a pixel (its own rows too)
        self.tests = np.zeros(shape, np.int64)  # segment minima read a pixel
        self.far = np.zeros(shape, np.int64)  # edt_dist: rows read from device memory


# ------------------------------------------------------------------ pass 2


def band_segment_walk(strip, gmin, c, best, start, walk, band, counts):
    """One field's segment walk (band_walk in csrc/edt.cu) for the pixels in
    ``walk``: c their strip rows, best their float32 minima; rows [max(c -
    band, 0), c - start] above and [c + start, min(c + band, h - 1)] below,
    nearest first, by the strip's 16-row segments (gmin: fl(min(m, clip)^2)
    per segment), a live segment's rows in chunks of 4. Returns the new
    minima."""
    n, h, w = strip.shape
    clip = band + 1
    ii, xx = np.arange(n)[:, None, None], np.arange(w)[None, None, :]
    lo, hi = np.maximum(c - band, 0), np.minimum(c + band, h - 1)
    ub, db = c - start, c + start
    up, dn = walk & (ub >= lo), walk & (db <= hi)
    su, sd = np.maximum(ub, 0) // SEG, db // SEG
    nseg = gmin.shape[1]
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
            a2 = sq(a0)
            on = on & ~(a2 >= best)
            counts.tests += on
            live = on & (gmin[ii, np.clip(s, 0, nseg - 1), xx] + a2 < best)
            for k in range(0, SEG, CHUNK):
                if not live.any():
                    break
                first = bot - k if side == "up" else top + k
                chunk = live & ((first >= top) if side == "up" else (first <= bot))
                brk = chunk & (sq(np.abs(c - first)) >= best)
                on, live, chunk = on & ~brk, live & ~brk, chunk & ~brk
                m = best
                for j in range(CHUNK):
                    r = first - j if side == "up" else first + j
                    act = chunk & ((r >= top) if side == "up" else (r <= bot))
                    tap = g_of(strip[ii, np.clip(r, 0, h - 1), xx], clip) + sq(np.abs(c - r))
                    m = np.where(act, np.minimum(m, tap), m)
                    counts.rows += act
                best = m
            if side == "up":
                up, su = on & (s * SEG > lo), su - 1
            else:
                dn, sd = on & (s * SEG + SEG - 1 < hi), sd + 1
    return best


def band_pixel_walk(strip, c, band, counts):
    """One field's per-pixel walk (edt_band_pixel): dy = 1, 2, ... until
    fl(dy^2) >= best or past min(band, max(c, h - 1 - c))."""
    n, h, w = strip.shape
    clip = band + 1
    ii, xx = np.arange(n)[:, None, None], np.arange(w)[None, None, :]
    best = g_of(strip[ii, c, xx], clip)
    counts.rows += 1
    reach = np.minimum(band, np.maximum(c, h - 1 - c))
    on = np.ones(c.shape, bool)
    for a in range(1, int(reach.max(initial=0)) + 1):
        on &= (a <= reach) & (sq(a) < best)
        if not on.any():
            break
        for r in (c - a, c + a):
            step = on & (r >= 0) & (r < h)
            best = np.where(step, np.minimum(best, g_of(strip[ii, np.clip(r, 0, h - 1), xx], clip) + sq(a)), best)
            counts.rows += step
    return best


def band_mirror(din, dout, band, row_off=0, out_rows=None, cap=CAP):
    """(D_in, D_out, counts, paths) of edt_band_bytes on strips (n, h, w):
    the float32 minima of output rows [0, out_rows) (strip rows from
    row_off), the counts a pixel, and the blocks' paths: (n, blocks down,
    blocks across) of 0 (dense, core only), 1 (dense, staged for pixels
    left), 2 (staged at once); None past shared memory."""
    din, dout = np.asarray(din), np.asarray(dout)
    n, h, w = din.shape
    out_rows = h - 2 * row_off if out_rows is None else out_rows
    clip = band + 1
    ii, xx = np.arange(n)[:, None, None], np.arange(w)[None, None, :]
    c = np.arange(out_rows)[None, :, None] + row_off + np.zeros((n, 1, w), np.int64)
    counts = Counts(c.shape)
    if not staged_fits(h, band, din.dtype.itemsize):
        return band_pixel_walk(din, c, band, counts), band_pixel_walk(dout, c, band, counts), counts, None

    own = [strip[ii, c, xx] for strip in (din, dout)]
    counts.rows += 2
    near = np.maximum(np.minimum(own[0].astype(np.int64), clip), np.minimum(own[1].astype(np.int64), clip)) <= cap
    dense = per_pixel(dense_blocks(near), out_rows, w)
    capr = min(cap, band)
    lim = np.minimum(band, np.maximum(c, h - 1 - c))
    best, done = [], []
    for strip, o in zip((din, dout), own):
        b = g_of(o, clip)
        running, a_stop = dense.copy(), np.full(c.shape, capr + 1)
        for a in range(1, capr + 1):
            a_stop = np.where(running & (a > lim), a, a_stop)
            running &= a <= lim
            brk = running & (sq(a) >= b)
            a_stop = np.where(brk, a, a_stop)
            running &= ~brk
            for r in (c - a, c + a):
                step = running & (r >= 0) & (r < h)
                b = np.where(step, np.minimum(b, g_of(strip[ii, np.clip(r, 0, h - 1), xx], clip) + sq(a)), b)
                counts.rows += step
        best.append(b)
        done.append(dense & ((a_stop > lim) | (sq(a_stop) >= b)))
    left = blocks_of(dense & ~(done[0] & done[1])) > 0
    dense_blocks_ = dense_blocks(near)
    paths = np.where(dense_blocks_, np.where(left, 1, 0), 2)

    # segment minima of the keys over the strip's 16-row segments
    nseg = -(-h // SEG)
    for f, strip in enumerate((din, dout)):
        key = np.abs(strip.astype(np.int64))
        pad = np.full((n, nseg * SEG - h, w), 1 << 40, np.int64)
        gmin = g_of(np.concatenate([key, pad], axis=1).reshape(n, nseg, SEG, w).min(axis=2), clip)
        start = np.where(dense, capr + 1, 1)
        best[f] = band_segment_walk(strip, gmin, c, best[f], start, ~done[f], band, counts)
    return best[0], best[1], counts, paths


def squares(d, clip):
    d = torch.clamp(d.to(torch.int32), max=clip).to(torch.float32)
    return d * d


def band_tail(d_in, d_out, spread, asymmetric, apply_sqrt):
    d_in, d_out = torch.from_numpy(d_in), torch.from_numpy(d_out)
    if apply_sqrt:
        d_in, d_out = refined_sqrt(d_in), refined_sqrt(d_out)
    return merge.remap_to_byte(merge.signed_merge(d_out, d_in), spread, asymmetric)


def _mask(kind, shape, seed):
    """Masks in the shapes of the card's inputs: sparse strokes in cells
    (some empty, as chip_smoke.glyph_image), noise, uniform, a lone seed."""
    rng = np.random.default_rng(seed)
    if kind == "glyph":
        m = np.zeros(shape, bool)
        h, w = shape[-2:]
        yy, xx = np.mgrid[:h, :w]
        for cy in range(0, h, 64):
            for cx in range(0, w, 64):
                if rng.random() < 0.35:
                    continue
                p0, p1 = rng.uniform(8, 56, 2) + (cy, cx), rng.uniform(8, 56, 2) + (cy, cx)
                d = p1 - p0
                t = np.clip(((yy - p0[0]) * d[0] + (xx - p0[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
                m[..., (yy - p0[0] - t * d[0]) ** 2 + (xx - p0[1] - t * d[1]) ** 2 <= rng.uniform(1, 9)] = True
        return m
    if kind == "noise":
        return rng.random(shape) < 0.5
    if kind == "one_seed":
        m = np.zeros(shape, bool)
        m[..., 0, 0] = True
        return m
    if kind in ("uniform0", "uniform1"):
        return np.full(shape, kind == "uniform1")
    raise ValueError(kind)


def _strips(kind, shape, band, seed=0):
    m = torch.from_numpy(_mask(kind, shape, seed))
    return cuda_edt.row_distances_u8_plain(m, band)


BAND_CASES = [
    # (kind, shape, spread): uint8 strips at spread 64, uint16 at 300, int32 at 65600
    ("glyph", (300, 200), 64),
    ("glyph", (2, 140, 75), 64),  # a batch; widths and heights off the block
    ("noise", (260, 100), 64),
    ("noise", (131, 40), 1),
    ("uniform0", (140, 40), 64),
    ("uniform1", (140, 40), 64),
    ("one_seed", (150, 33), 64),
    ("glyph", (700, 40), 300),  # uint16, staged
    ("noise", (300, 40), 300),
    ("glyph", (120, 20), 65600),  # int32, staged (a strip of at most ~854 rows)
]


@pytest.mark.parametrize("kind,shape,spread", BAND_CASES)
def test_band_mirror_is_the_plain_pass2(kind, shape, spread):
    """Both fields' minima are the plain column minima bit for bit, and
    through the plain tail the bytes are fused_pass2_bytes_plain's; no path
    reads more rows in all than the per-pixel walk."""
    band = spread + 2
    din, dout = _strips(kind, shape, band, spread)
    d_in, d_out, counts, paths = band_mirror(din.numpy().reshape((-1,) + shape[-2:]),
                                             dout.numpy().reshape((-1,) + shape[-2:]), band)
    for got, strip in ((d_in, din), (d_out, dout)):
        want = edt.band_min_columns(squares(strip, band + 1), band).reshape(got.shape)
        np.testing.assert_array_equal(got.view(np.int32), want.numpy().view(np.int32))
    apply_sqrt = shape[-2] > 1
    got_bytes = band_tail(d_in, d_out, spread, False, apply_sqrt).reshape(shape)
    assert torch.equal(got_bytes, cuda_edt.fused_pass2_bytes_plain(din, dout, spread, False, band, apply_sqrt))
    assert paths is not None
    pix = Counts(counts.rows.shape)
    n = counts.rows.shape[0]
    c = np.arange(shape[-2])[None, :, None] + np.zeros((n, 1, shape[-1]), np.int64)
    for strip in (din, dout):
        band_pixel_walk(strip.numpy().reshape((n,) + shape[-2:]), c, band, pix)
    assert counts.rows.sum() <= pix.rows.sum()


def test_band_mirror_paths_on_noise_and_strokes():
    """Noise: every block dense and done within K (no block stages more), a
    pixel reads a few rows. Strokes: blocks away from them stage at once,
    and a pixel far from a stroke reads its own rows and tests about 2 band /
    16 segments of its far field."""
    band = 66
    din, dout = _strips("noise", (256, 64), band, 1)
    _, _, counts, paths = band_mirror(din.numpy()[None], dout.numpy()[None], band)
    assert (paths == 0).all() and counts.rows.mean() < 6 and counts.tests.sum() == 0
    m = np.zeros((384, 64), bool)
    m[190:194, 10:50] = True
    din, dout = cuda_edt.row_distances_u8_plain(torch.from_numpy(m), band)
    _, _, counts, paths = band_mirror(din.numpy()[None], dout.numpy()[None], band)
    assert (paths == 2).all()
    far = counts.rows[0, :40]  # rows more than band away from the stroke
    assert (far == 2).all() and (counts.tests[0, :40] <= 2 * (band // SEG + 2)).all()


def test_dense_block_stages_for_pixels_left():
    """Noise with a hole of 40 rows: the blocks around the hole are dense,
    and those whose pixels in the hole are left past K stage the rest."""
    rng = np.random.default_rng(5)
    m = rng.random((256, 32)) < 0.5
    m[100:140, :] = False
    m[100:140, 16] = True  # a column of seeds: near pixels stay in the hole
    din, dout = cuda_edt.row_distances_u8_plain(torch.from_numpy(m), 66)
    d_in, d_out, _, paths = band_mirror(din.numpy()[None], dout.numpy()[None], 66)
    assert (paths == 1).all()
    for got, strip in ((d_in, din), (d_out, dout)):
        np.testing.assert_array_equal(got[0].view(np.int32), edt_min(strip, 66).view(np.int32))


def edt_min(strip, band):
    return edt.band_min_columns(squares(strip, band + 1), band).numpy()


def test_band_mirror_single_row_without_sqrt():
    """One row: the reference never applies the pass-2 sqrt."""
    din, dout = _strips("noise", (1, 90), 66, 3)
    d_in, d_out, _, _ = band_mirror(din.numpy()[None], dout.numpy()[None], 66)
    got = band_tail(d_in, d_out, 64, False, False)[0]
    assert torch.equal(got, cuda_edt.fused_pass2_bytes_plain(din, dout, 64, False, 66, False))


@pytest.mark.parametrize("dtype,band,high", [(torch.uint8, 42, 256), (torch.uint16, 400, 1 << 16),
                                              (torch.int32, 65602, 1 << 26)])
def test_band_mirror_on_any_strips(dtype, band, high):
    """Strips that are not row distances (values past the clip, int32 ones
    whose squares pass 2^24, negative int32 ones): the segment bound, formed
    with the taps' rounding from the least |v| of a segment, skips nothing
    that could lower a minimum."""
    rng = np.random.default_rng(band)
    shape = (2, 150, 40)
    lo = -high if dtype == torch.int32 else 0
    din = rng.integers(lo, high, size=shape).astype(np.int64)
    dout = rng.integers(0, high, size=shape).astype(np.int64)
    din[:, 20:60] = high - 1  # a run of segments the bound must skip
    np_dtype = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.int32: np.int32}[dtype]
    din, dout = din.astype(np_dtype), dout.astype(np_dtype)
    d_in, d_out, _, _ = band_mirror(din, dout, band)
    for got, strip in ((d_in, din), (d_out, dout)):
        want = edt_min(torch.from_numpy(strip), band)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype,band,shape", [(torch.int32, 65602, (900, 8)), (torch.uint16, 800, (1800, 4)),
                                              (torch.int32, 65602, (854, 8)), (torch.uint16, 728, (1800, 4))])
def test_band_mirror_past_shared_memory(dtype, band, shape):
    """Windows past a block's shared memory take the per-pixel walk:
    int32 strips of 854 rows or more, uint16 ones from band 728."""
    din, dout = _strips("glyph", shape, band, 2)
    assert din.dtype == dtype and not staged_fits(shape[0], band, din.element_size())
    d_in, d_out, _, paths = band_mirror(din.numpy()[None], dout.numpy()[None], band)
    assert paths is None
    got = band_tail(d_in, d_out, band - 2, False, True)[0]
    assert torch.equal(got, cuda_edt.fused_pass2_bytes_plain(din, dout, band - 2, False, band))


@pytest.mark.parametrize("band,halo,rows", [(66, 66, 200), (302, 302, 150), (30, 30, 64)])
def test_band_mirror_on_row_offset_frames(band, halo, rows):
    """A shard's frame (parallel/sharded.py): its rows with `halo` rows of
    each neighbour, the dtype's maximum beyond the image (pass 2 clips it to
    band + 1); output row y reads frame row y + row_off."""
    full = _mask("glyph", (3 * rows, 70), band)
    din, dout = cuda_edt.row_distances_u8_plain(torch.from_numpy(full), band)
    fill = torch.iinfo(din.dtype).max
    for shard in range(3):
        lo, hi = shard * rows - halo, (shard + 1) * rows + halo
        frames = []
        for strip in (din, dout):
            f = torch.full((hi - lo, 70), fill, dtype=strip.dtype)
            f[max(lo, 0) - lo : min(hi, 3 * rows) - lo] = strip[max(lo, 0) : min(hi, 3 * rows)]
            frames.append(f)
        d_in, d_out, _, _ = band_mirror(frames[0].numpy()[None], frames[1].numpy()[None], band, halo, rows)
        got = band_tail(d_in, d_out, band - 2, False, True)[0]
        want = cuda_edt.fused_pass2_bytes_plain(frames[0], frames[1], band - 2, False, band, True, halo, rows)
        assert torch.equal(got, want)
        one = cuda_edt.fused_pass2_bytes_plain(din, dout, band - 2, False, band)[shard * rows : (shard + 1) * rows]
        assert torch.equal(got, one)


# ---------------------------------------------------------------- edt_dist


def dist_mirror(d, sat, cap=CAP, halo=DIST_HALO):
    """(best, counts, paths) of exact_dist on a uint16 strip (n, h, w): the
    int64 minimum a pixel reaches, the counts a pixel (rows from device
    memory in counts.far), and the blocks' paths (0 dense core only, 1
    dense and staged, 2 staged at once)."""
    d = np.asarray(d).astype(np.int64)
    n, h, w = d.shape
    ii, xx = np.arange(n)[:, None, None], np.arange(w)[None, None, :]
    y = np.arange(h)[None, :, None] + np.zeros((n, 1, w), np.int64)
    g = np.minimum(d, sat) ** 2
    counts = Counts(y.shape)
    best = g.copy()
    counts.rows += 1
    near = np.minimum(d, sat) <= cap
    dense_b = dense_blocks(near)
    dense = per_pixel(dense_b, h, w)
    lim = np.maximum(y, h - 1 - y)
    running, a_stop = dense.copy(), np.full(y.shape, cap + 1)
    for a in range(1, cap + 1):
        a_stop = np.where(running & (a > lim), a, a_stop)
        running &= a <= lim
        brk = running & (a * a >= best)
        a_stop = np.where(brk, a, a_stop)
        running &= ~brk
        for r in (y - a, y + a):
            step = running & (r >= 0) & (r < h)
            best = np.where(step, np.minimum(best, g[ii, np.clip(r, 0, h - 1), xx] + a * a), best)
            counts.rows += step
    done = dense & ((a_stop > lim) | (a_stop * a_stop >= best))
    paths = np.where(dense_b, np.where(blocks_of(dense & ~done) > 0, 1, 0), 2)

    nseg = -(-h // SEG)
    pad = np.full((n, nseg * SEG - h, w), sat, np.int64)
    table = np.concatenate([np.minimum(d, sat), pad], axis=1).reshape(n, nseg, SEG, w).min(axis=2)
    np.testing.assert_array_equal(table, cuda_edt.dist_table_plain(torch.from_numpy(d.astype(np.int32)), sat).to(
        torch.int32).numpy())
    y0 = y // ROWS * ROWS
    wlo, whi = np.maximum(y0 - halo, 0), np.minimum(np.minimum(y0 + ROWS, h) + halo, h)
    start = np.where(dense, cap + 1, 1)
    best = dist_segment_walk(g, table, y, best, start, ~done, wlo, whi, counts)
    return best, counts, paths


def dist_segment_walk(g, table, y, best, start, walk, wlo, whi, counts):
    """edt_dist_staged's segment walk for the pixels in ``walk`` (rows y,
    minima best): rows [0, y - start] above and [y + start, h) below by the
    table's 16-row segments, a live segment's rows in chunks of 4, read from
    the block's window [wlo, whi) or from device memory (counts.far).
    Returns the new minima."""
    n, h, w = g.shape
    nseg = table.shape[1]
    ii, xx = np.arange(n)[:, None, None], np.arange(w)[None, None, :]
    ub, db = y - start, y + start
    up, dn = walk & (ub >= 0), walk & (db < h)
    su, sd = np.maximum(ub, 0) // SEG, db // SEG
    while (up | dn).any():
        for side in ("up", "dn"):
            on = up if side == "up" else dn
            s = su if side == "up" else sd
            if side == "up":
                top, bot = s * SEG, np.minimum(s * SEG + SEG - 1, ub)
                a0 = y - bot
            else:
                top, bot = np.maximum(s * SEG, db), np.minimum(s * SEG + SEG - 1, h - 1)
                a0 = top - y
            on = on & ~(a0 * a0 >= best)
            counts.tests += on
            m = table[ii, np.clip(s, 0, nseg - 1), xx]
            live = on & (a0 * a0 + m * m < best)
            staged = (s * SEG >= wlo) & (s * SEG < whi)
            for k in range(0, SEG, CHUNK):
                if not live.any():
                    break
                first = bot - k if side == "up" else top + k
                chunk = live & ((first >= top) if side == "up" else (first <= bot))
                brk = chunk & ((y - first) ** 2 >= best)
                on, live, chunk = on & ~brk, live & ~brk, chunk & ~brk
                m = best
                for j in range(CHUNK):
                    r = first - j if side == "up" else first + j
                    act = chunk & ((r >= top) if side == "up" else (r <= bot))
                    tap = g[ii, np.clip(r, 0, h - 1), xx] + (y - r) ** 2
                    m = np.where(act, np.minimum(m, tap), m)
                    counts.rows += act
                    counts.far += act & ~staged
                best = m
            if side == "up":
                up, su = on & (s > 0), su - 1
            else:
                dn, sd = on & (bot < h - 1), sd + 1
    return best


def dist_of(best, sat):
    """exact_dist's tail: NO_SEED where best >= sat^2, else the correctly
    rounded sqrt of the integer as float32."""
    dist = refined_sqrt(torch.from_numpy(best.astype(np.float32)))
    return torch.where(torch.from_numpy(best >= sat * sat), torch.full_like(dist, cuda_edt.NO_SEED), dist)


def _dist_strip(kind, shape, seed=0):
    b = torch.from_numpy(_mask(kind, shape, seed)) if isinstance(kind, str) else torch.from_numpy(kind)
    sat = cuda_edt.dist_sat(max(shape[-2:]))
    din, dout = cuda_edt.row_distances_u8_plain(b, sat - 1)
    return din, dout, sat


DIST_CASES = [
    ("glyph", (300, 200)),
    ("glyph", (3, 140, 75)),  # a batch; heights not a multiple of 16 or 128
    ("noise", (260, 100)),
    ("one_seed", (333, 50)),  # one seed in a corner
    ("uniform0", (150, 40)),  # no seed: NO_SEED everywhere for din
    ("uniform1", (150, 40)),
    ("glyph", (4104, 6)),  # the second saturation tier, 16383
]


@pytest.mark.parametrize("kind,shape", DIST_CASES)
def test_dist_mirror_is_the_plain_field(kind, shape):
    """Both strips' fields bit for bit exact_dist_plain's."""
    din, dout, sat = _dist_strip(kind, shape, 7)
    for strip in (din, dout):
        s3 = strip.reshape((-1,) + shape[-2:])
        best, counts, paths = dist_mirror(s3.numpy(), sat)
        # the mirror's paths (0 dense and done, 1 dense with pixels left, 2 sparse) as edt_dist_core's flags
        np.testing.assert_array_equal(np.array([0, 2, 1])[paths], cuda_edt.dist_left_plain(s3, sat).numpy())
        got = dist_of(best, sat).reshape(shape)
        want = cuda_edt.exact_dist_plain(strip, sat)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert (counts.rows >= 1).all()
    if shape[0] == 4104:
        assert sat == 16383


def test_dist_paths_and_counts():
    """Noise: dense blocks, done within K, no segment tests. A lone seed in
    a corner: every block stages at once, and a pixel reads rows only in
    the segments whose least value is near enough, some of them past the
    block's window, from device memory. No seed: NO_SEED everywhere; a
    pixel reads its own row and tests every segment (2 H / 16 steps)."""
    din, dout, sat = _dist_strip("noise", (256, 64), 3)
    _, counts, paths = dist_mirror(din.numpy()[None], sat)
    assert (paths == 0).all() and counts.tests.sum() == 0 and counts.rows.mean() < 4
    din, _, sat = _dist_strip("one_seed", (512, 64))
    _, counts, paths = dist_mirror(din.numpy()[None], sat)
    assert (paths == 2).all()
    assert counts.rows.mean() < 20 and counts.far.sum() > 0
    empty = np.full((1, 300, 40), sat, np.uint16)
    best, counts, _ = dist_mirror(empty, sat)
    nseg = -(-300 // SEG)
    assert (best >= sat * sat).all() and (counts.rows == 1).all()
    assert ((counts.tests >= nseg) & (counts.tests <= nseg + 1)).all()


@pytest.mark.parametrize("h,band,itemsize,staged", [(1613, 800, 2, True), (1614, 800, 2, False),
                                                     (1800, 727, 2, True), (1800, 728, 2, False),
                                                     (853, 65602, 4, True), (854, 65602, 4, False),
                                                     (4096, 253, 1, True)])
def test_staged_fits_at_the_shared_memory_limit(h, band, itemsize, staged):
    """The windows at the edge of a block's shared memory, where the static
    part decides: uint16 strips of 1613 rows or up to band 727 stage, int32
    strips of up to 853 rows; uint8 always."""
    assert staged_fits(h, band, itemsize) == staged


def test_dist_table_is_segment_minima():
    d = torch.from_numpy(np.random.default_rng(1).integers(0, 9000, size=(2, 37, 5)).astype(np.uint16))
    t = cuda_edt.dist_core(d, 8191)[1].to(torch.int32)
    assert t.shape == (2, 3, 5)
    dd = torch.clamp(d.to(torch.int32), max=8191)
    for s in range(3):
        assert torch.equal(t[:, s], dd[:, 16 * s : 16 * s + 16].amin(1))


# ------------------------------------------------------------ against JAX


def test_band_mirror_matches_jax_pallas():
    """The mirror of pass 2 on pass 1's strips against the JAX pipeline in
    interpret mode, 64 x 56 strokes at spread 13."""
    import jax.numpy as jnp

    from chaq_sdfgen_tpu.ops import pallas_edt

    b = _mask("glyph", (64, 56), 4) | (np.random.default_rng(4).random((64, 56)) < 0.02)
    spread, band = 13, 15
    din, dout = cuda_edt.row_distances_u8_plain(torch.from_numpy(b), band)
    d_in, d_out, _, _ = band_mirror(din.numpy()[None], dout.numpy()[None], band)
    got = band_tail(d_in, d_out, spread, False, True)[0].numpy()
    want = np.asarray(pallas_edt.fused_sdf_bytes(jnp.asarray(b), spread, False, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_dist_mirror_matches_jax_pallas():
    """The mirror of edt_dist on pass 1's in-strip against JAX's exact
    distance field in interpret mode, 64 x 48 at 1% TRUE."""
    import jax.numpy as jnp

    from chaq_sdfgen_tpu.ops import pallas_edt

    b = np.random.default_rng(11).random((64, 48)) < 0.01
    din, _, sat = _dist_strip(b, b.shape)
    best, _, _ = dist_mirror(din.numpy()[None], sat)
    got = dist_of(best, sat)[0].numpy()
    want = np.asarray(pallas_edt.exact_distance_field(jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
