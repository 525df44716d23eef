"""The cols-conv kernels' schedule (csrc/band_conv.cu: cols_conv,
p2_fused_fwd, p2_fused_bwd), mirrored in NumPy and held against the plain
versions that the kernels match on the card.

A block owns 32 columns (a column tile) of one image and walks a strip of
output rows in 64-row chunks. The launcher sizes the strips: whole chunks,
as many strips a tile as fill the card's resident blocks once (SMs x blocks
an SM over the tiles of all images). Chunk c's window is 64 + 2k rows of
the input, window row j being input row y0 + 64 c + j (y0 = the strip's
first output row + row_off - k); chunk 0 stages its whole window, a later
chunk carries the last window's last 2k rows over and produces 64 new
ones, so each staged input row is produced once a strip. A warp takes 8
consecutive output rows of the chunk, a lane one column: its register
window is window rows 8 g .. 8 g + 7 + 2k, and output row t of the chunk
sums window rows t .. t + 2k, d = -k .. k ascending, each multiply and add
rounded on its own. The tap loop is unrolled up to the radius limit, 128,
each step behind a test of the radius: one instance serves every radius,
its taps a kernel parameter.

The mirror holds that every output is written exactly once, that every
window row a thread reads holds the input row the plain conv reads there
(staged for that strip, zero outside the input), that each input row is
produced once a strip, and that the tiled sums give cols_conv_plain,
p2_fused_fwd_plain (the tails over them) and p2_fused_bwd_plain (the tails'
VJP as the producer) bit for bit (tolerance 0: the same float32 operations
on the CPU, element by element).
"""

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.ops import band_conv, soft_mxu

COLS, PER, WARPS = 32, 8, 8  # columns a block, outputs a thread, warps a block
CHUNK = PER * WARPS  # output rows a chunk
UNROLL = 128  # the radius the tap loop is unrolled to
PARAM_LIMIT = 4096  # bytes of a kernel's parameters
SMEM_LIMIT = 227 * 1024  # the opt-in shared memory of a block on an H100
EPS = 1e-6


def smem_bytes(fields: int, k: int) -> int:
    """Two window buffers of each field."""
    return 4 * 2 * fields * (CHUNK + 2 * k) * COLS


def strip_rows(h_out: int, w: int, n: int, sms: int, per_sm: int) -> int:
    """The launcher's strip: whole chunks, as many strips a tile as fill
    sms x per_sm resident blocks over the tiles of all n images, at least
    one, at most one a chunk."""
    tiles, chunks = -(-w // COLS) * n, -(-h_out // CHUNK)
    strips = min(max(sms * max(per_sm, 1) // tiles, 1), chunks)
    return -(-chunks // strips) * CHUNK


def walk(raw, produce, k, temperature, row_off, h_out, nf, sms=4, per_sm=2):
    """The kernel's schedule on the raw inputs ``raw`` (a list of (n, h_in,
    W) float32 tensors): ``produce`` turns the raw values of a run of staged
    pixels into each field's conv input. Returns the tiled sums of the nf
    fields, (n, h_out, W) each, and the producer's pixel count; asserts the
    schedule's invariants on the way."""
    n, h_in, w = raw[0].shape
    taps = np.asarray(soft_mxu.tap_weights(k, temperature), np.float32)
    span = CHUNK + 2 * k
    strip = strip_rows(h_out, w, n, sms, per_sm)
    assert strip % CHUNK == 0 and -(-w // COLS) * n * -(-h_out // strip) <= max(sms * per_sm, -(-w // COLS) * n)
    sums = np.zeros((nf, n, h_out, w), np.float32)
    writes = np.zeros((n, h_out, w), np.int64)
    produced = 0
    for z in range(n):
        for x0 in range(0, w, COLS):
            xs = np.arange(x0, x0 + COLS)
            col_in = xs < w
            for o_start in range(0, h_out, strip):
                o_end = min(o_start + strip, h_out)
                chunks = -(-(o_end - o_start) // CHUNK)
                y0 = o_start + row_off - k
                # the strip's window rows, each produced once: chunk 0's span
                # rows, then 64 new rows a chunk
                rows = CHUNK * chunks + 2 * k
                ys = y0 + np.arange(rows)
                inside = (ys >= 0) & (ys < h_in)
                vals = np.zeros((nf, rows, COLS), np.float32)
                if inside.any():
                    got = [r[z, ys[inside]][:, xs[col_in]] for r in raw]
                    for f, v in enumerate(produce(*got)):
                        vals[f][np.ix_(inside, col_in)] = v.numpy()
                produced += int(inside.sum()) * int(col_in.sum())
                made = np.zeros(rows, np.int64)
                src = np.full(span, -1)  # the strip-window row each window row holds
                buf = np.zeros((nf, span, COLS), np.float32)
                for c in range(chunks):
                    if c == 0:
                        new = np.arange(span)
                    else:  # carry the last 2k rows, then 64 new ones
                        src[: 2 * k], buf[:, : 2 * k] = src[CHUNK:].copy(), buf[:, CHUNK:].copy()
                        new = np.arange(2 * k, span)
                    src[new] = CHUNK * c + new
                    buf[:, new] = vals[:, CHUNK * c + new]
                    made[CHUNK * c + new] += 1
                    assert (src == CHUNK * c + np.arange(span)).all()  # the window holds its rows
                    # warp g's register window: rows 8 g .. 8 g + 7 + 2k
                    assert WARPS * PER - 1 + 2 * k <= span - 1
                    acc = np.zeros((nf, CHUNK, COLS), np.float32)
                    steps = 0
                    for i in range(2 * UNROLL + 1):  # d = -k .. k, the unrolled loop's steps
                        if i > 2 * k:
                            break
                        acc = acc + taps[i] * buf[:, i : i + CHUNK]
                        steps += 1
                    assert steps == len(taps) == 2 * k + 1
                    o = o_start + CHUNK * c + np.arange(CHUNK)
                    live = o < o_end
                    sums[:, z][np.ix_(range(nf), o[live], xs[col_in])] = acc[:, live][:, :, col_in]
                    writes[z][np.ix_(o[live], xs[col_in])] += 1
                assert (made == 1).all()  # each input row of the strip produced once
    assert (writes == 1).all()  # every output written exactly once
    return [torch.from_numpy(s) for s in sums], produced


def bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def slabs(n, h, w, k, seed):
    """Two pass-1 sums of a halo'd slab (n, h + 2k, w) and a cotangent (n,
    h, w); the second sum is zero on its first columns (dead windows)."""
    rng = np.random.default_rng(seed)
    a = [torch.from_numpy((rng.random((n, h + 2 * k, w)) * 2).astype(np.float32)) for _ in range(2)]
    a[1][..., : w // 3 + 1] = 0.0
    ct = torch.from_numpy(rng.standard_normal((n, h, w)).astype(np.float32))
    return a, ct


def params(k):
    return (8.0, 30.0) if k > 16 else (1.0, 3.0)  # T, shift


CASES = [  # (n, h, w, k, sms, blocks an SM)
    (1, 40, 9, 0, 4, 2), (3, 70, 65, 1, 4, 2), (1, 200, 33, 10, 4, 2), (2, 130, 130, 16, 3, 1),
    (1, 150, 40, 17, 2, 2), (1, 300, 65, 29, 8, 2), (1, 100, 9, 128, 2, 1), (3, 257, 9, 10, 1, 1),
    (1, 1, 65, 3, 4, 2), (1, 129, 130, 29, 132, 8),
]


@pytest.mark.parametrize("n,h,w,k,sms,per_sm", CASES)
@pytest.mark.parametrize("direction", ["interior", "onto the slab"])
def test_cols_conv_tiles_match_plain(n, h, w, k, sms, per_sm, direction):
    (a, _), ct = slabs(n, h, w, k, seed=k + h)
    t = params(k)[0]
    e, row_off, h_out = (a, k, h) if direction == "interior" else (ct, -k, h + 2 * k)
    (got,), _ = walk([e], lambda v: (v,), k, t, row_off, h_out, 1, sms, per_sm)
    assert bits(got, band_conv.cols_conv_plain(e, k, t, row_off, h_out))


@pytest.mark.parametrize("n,h,w,k,sms,per_sm", CASES)
def test_p2_fused_fwd_tails_over_the_tiles_match_plain(n, h, w, k, sms, per_sm):
    a, _ = slabs(n, h, w, k, seed=2 * k + h)
    t, shift = params(k)
    (s_in, s_out), _ = walk(a, lambda u, v: (u, v), k, t, k, h, 2, sms, per_sm)
    got = soft_mxu.tails(s_in, s_out, t, shift, EPS)
    want = band_conv.p2_fused_fwd_plain(a[0], a[1], k, t, shift, EPS)
    assert all(bits(x, y) for x, y in zip(got, want))
    assert bool((want[2] >= 1e29).any())  # dead windows in the case


@pytest.mark.parametrize("n,h,w,k,sms,per_sm", CASES)
def test_p2_fused_bwd_vjp_producer_tiles_match_plain(n, h, w, k, sms, per_sm):
    a, ct = slabs(n, h, w, k, seed=3 * k + h)
    t, shift = params(k)
    _, d2i, d2o = band_conv.p2_fused_fwd_plain(a[0], a[1], k, t, shift, EPS)
    vjp = lambda g, u, v: soft_mxu.tails_vjp(g, u, v, t, shift, EPS)  # noqa: E731
    got, produced = walk([ct, d2i, d2o], vjp, k, t, -k, h + 2 * k, 2, sms, per_sm)
    want = band_conv.p2_fused_bwd_plain(ct, d2i, d2o, k, t, shift, EPS)
    assert all(bits(x, y) for x, y in zip(got, want))
    # the VJP runs once a pixel a strip: no more often than the parent's
    # 64-row tiles, each of which ran it on the live rows of its whole
    # window (output rows o .. o + 63 read input rows o - 2k .. o + 63)
    parent = sum(max(min(o + CHUNK, h) - max(o - 2 * k, 0), 0) for o in range(0, h + 2 * k, CHUNK)) * w * n
    assert produced <= parent


@pytest.mark.parametrize("h_out,w,n", [(1024, 4096, 1), (1082, 4096, 1), (1000, 4096, 1), (1020, 4096, 1),
                                       (300, 4096, 1), (600, 4096, 3), (77, 33, 2), (5000, 64, 1)])
@pytest.mark.parametrize("per_sm", [1, 2, 3, 4, 6, 8])
def test_strips_fill_the_resident_blocks_once(h_out, w, n, per_sm):
    """The launcher's strips on an H100 (132 SMs): whole chunks covering
    every output row, at most one wave of resident blocks unless one strip
    a tile is already more, and the fewest strips that fill it (a taller
    strip produces its 2k halo rows fewer times)."""
    sms, tiles, chunks = 132, -(-w // COLS) * n, -(-h_out // CHUNK)
    strip = strip_rows(h_out, w, n, sms, per_sm)
    strips = -(-h_out // strip)
    assert strip % CHUNK == 0 and strips * strip >= h_out and (strips - 1) * strip < h_out
    assert tiles * strips <= max(sms * per_sm, tiles)
    if strips < chunks:  # one more strip would not fit in the wave, or would be one chunk more
        assert tiles * (strips + 1) > sms * per_sm or -(-chunks // (strips + 1)) * CHUNK == strip


def test_tap_loop_and_shared_memory():
    """The unrolled loop's 2 x 128 + 1 steps hold every radius's 2k + 1
    taps, and the taps with the frame (5 ints) and the largest producer
    (3 pointers and 4 floats) and epilogue (3 pointers and 3 floats) fit a
    kernel's parameters; the two buffers fit a block's shared memory at
    every radius and field count, 31 KB at the wide path's k 29 and 43 KB
    for the pair at k 10."""
    assert band_conv.MAX_TAPS == UNROLL
    assert 4 * (2 * UNROLL + 1) + 4 * 5 + (3 * 8 + 4 * 4) + (3 * 8 + 3 * 4) + 4 <= PARAM_LIMIT
    for k in range(band_conv.MAX_TAPS + 1):
        assert 2 * UNROLL + 1 >= 2 * k + 1
        assert smem_bytes(2, k) <= SMEM_LIMIT
    assert smem_bytes(1, 29) == 31232 and smem_bytes(2, 10) == 43008 and smem_bytes(2, 128) == 163840
