"""The row passes' warp walk (csrc/row_words.cuh; edt_rows takes it with K = 1,
brute_rows with K = 2), mirrored in NumPy and held bit for bit against the
plain versions that the kernels match on the card, and against the JAX
package:

  a warp takes a segment of a row: up to 8 steps of 32 chunks, a chunk the 16
  pixels of one 16-byte word of the flat (rows, w) codes (so a row whose
  offset is not 16-aligned starts and ends with a partial chunk, read and
  written a pixel at a time). Each chunk becomes a 32-bit mask, TRUE seeds
  (code 1) in bits 0-15 and FALSE (code 0) in 16-31: a word of 0/1 codes by
  one multiply, any other by byte tests and one multiply (code_flags). Left
  to right the warp keeps the K last seeds before each step; right to left
  the K first after it; each lane takes its chunk's K nearest seeds outside
  it on both sides from a ballot of the lanes that hold one and the masks of
  the K nearest such lanes (clz before, ffs after), merged with the step's
  carry by the top-2 rule. The epilogue walks the chunk's 16 pixels two a
  step, pixel i and i + 8 in the halves of a 32-bit word (up to a clip of
  65519; above it a pixel a step), and every output is written once. A
  segment that does not start (end) its row takes the seeds before (after)
  it from the codes around it, 32 chunks a round, until it holds K of each
  polarity, the rest lie clip away, or the row ends. Rows are cut into
  segments where whole rows would give a launch fewer than 2048 warps. Which
  warp takes which segment (the kernel's grid holds the resident blocks)
  changes no value and is not mirrored.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chaq_sdfgen_tpu.ops import brute as jbrute
from chaq_sdfgen_tpu.ops import pallas_edt
from chaq_sdfgen_tpu_torch.ops import cuda_brute, cuda_edt

CHUNK, LANES, STEPS, TARGET_WARPS = 16, 32, 8, 2048
NONE, FAR = -(1 << 30), 1 << 30
ALL = 0xFFFFFFFF
WIDTHS = [1, 17, 31, 32, 33, 131, 513, 1100]


def code_flags(v: np.ndarray) -> np.ndarray:
    """Bits 0-3: which of a 32-bit word's 4 codes are 1; bits 4-7: which are
    0 (the kernel's byte tests and multiply, in 32-bit arithmetic)."""
    v = v.astype(np.uint64)
    u = v ^ 0x01010101
    one = ~(((u & 0x7F7F7F7F) + 0x7F7F7F7F) | u) & 0x80808080
    zero = ~(((v & 0x7F7F7F7F) + 0x7F7F7F7F) | v) & 0x80808080
    return ((((one >> 7) | (zero >> 3)) * 0x00204081) & ALL) >> 21 & 0xFF


def word_mask(b16: np.ndarray) -> int:
    """A chunk's mask from its 16 codes held as four little-endian words;
    where every code is 0 or 1, the FALSE seeds are the TRUE ones'
    complement and each word's TRUE flags are one multiply."""
    words = [int(x) for x in b16.view("<u4")]
    m = 0
    if not (words[0] | words[1] | words[2] | words[3]) & 0xFEFEFEFE:
        for k, x in enumerate(words):
            m |= ((x * 0x00204081 & ALL) >> 21 & 0xF) << (4 * k)
        return m | (~m & 0xFFFF) << 16
    flags = code_flags(np.array(words, np.uint64))
    for k in range(4):
        f = int(flags[k])
        m |= (f & 0xF) << (4 * k) | (f >> 4) << (16 + 4 * k)
    return m


def chunk_mask(flat: np.ndarray, j: int, e0: int, w: int, vec: bool) -> int:
    if vec and j * CHUNK >= e0 and j * CHUNK + CHUNK <= e0 + w:
        return word_mask(flat[j * CHUNK: j * CHUNK + CHUNK])
    m = 0
    for i in range(CHUNK):
        e = j * CHUNK + i
        if e0 <= e < e0 + w:
            m |= int(flat[e] == 1) << i | int(flat[e] == 0) << (16 + i)
    return m


def hi_bit(c: int) -> int:  # 31 - clz(c): -1 for 0
    return c.bit_length() - 1


def lo_bit(c: int) -> int:  # ffs(c) - 1: -1 for 0
    return (c & -c).bit_length() - 1


def ballot(masks, pol: int) -> int:
    return sum(1 << lane for lane, m in enumerate(masks) if (m >> (16 * pol)) & 0xFFFF)


def nearest(masks, bal: int, lanes: int, pol: int, x0: int, k: int, before: bool) -> list:
    """The kernel's nearest(): the k nearest seeds of polarity pol in the
    chunks of `lanes`, from the ballot and the masks of (at most) two lanes."""
    c = bal & lanes
    pick, none = (hi_bit, NONE) if before else (lo_bit, FAR)
    h1 = pick(c)
    m1 = (masks[h1 & 31] >> (16 * pol)) & 0xFFFF
    b1 = pick(m1)
    p = [x0 + CHUNK * h1 + b1 if c else none]
    if k == 2:
        c2 = c & ~(1 << (h1 & 31)) & ALL if before else c & (c - 1)
        h2 = pick(c2)
        m2 = (masks[h2 & 31] >> (16 * pol)) & 0xFFFF
        r1 = m1 & ~(1 << (b1 & 31)) & ALL if before else m1 & (m1 - 1)
        p.append(x0 + CHUNK * h1 + pick(r1) if c and r1 else x0 + CHUNK * h2 + pick(m2) if c2 else none)
    return p


def merge(a: list, b: list, before: bool) -> list:
    best, worst = (max, min) if before else (min, max)
    if len(a) == 1:
        return [best(a[0], b[0])]
    return [best(a[0], b[0]), best(worst(a[0], b[0]), best(a[1], b[1]))]


def take(c: dict, masks, bals, lanes: int, x0: int, k: int, before: bool) -> dict:
    """Both polarities of a step (bals: its two ballots) into c."""
    return {pol: merge(c[pol], nearest(masks, bals[pol], lanes, pol, x0, k, before), before) for pol in (0, 1)}


def none_near(k: int, before: bool) -> dict:
    return {pol: [NONE if before else FAR] * k for pol in (0, 1)}


def look_around(c, flat, e0, w, jr0, jr1, jedge, xb, clip, k, vec, before, reads):
    """The seeds before (after) a segment, 32 chunks a round."""
    base = jedge - LANES if before else jedge + 1
    none = NONE if before else FAR
    while True:
        masks = []
        for lane in range(LANES):
            j = base + lane
            x = j * CHUNK - e0
            near = x + CHUNK > xb - clip if before else x < xb + clip
            read = jr0 <= j <= jr1 and near
            reads[1] += read
            masks.append(chunk_mask(flat, j, e0, w, vec) if read else 0)
        x0 = base * CHUNK - e0
        c = take(c, masks, (ballot(masks, 0), ballot(masks, 1)), ALL, x0, k, before)
        ends = (base <= jr0 or x0 <= xb - clip) if before else (base + LANES > jr1 or x0 + LANES * CHUNK >= xb + clip)
        if ends or (c[0][k - 1] != none and c[1][k - 1] != none):
            return c
        base += -LANES if before else LANES


def segments(nrows: int, w: int) -> tuple:
    """The launcher's (steps a segment, segments a row)."""
    chunks = w // CHUNK if w % CHUNK == 0 else (w + CHUNK - 2) // CHUNK + 1
    count = lambda st: -(-chunks // (LANES * st))  # noqa: E731
    s = min(STEPS, -(-chunks // LANES))
    while s > 1 and nrows * count(s) < TARGET_WARPS:
        s = (s + 1) // 2
    return s, count(s)


def walk(codes: np.ndarray, clip: int, k: int, steps=None, vec=True):
    """Every warp of a launch: the chunks each hands its epilogue, as
    (e0, j, mask, before, after), and the chunks read (phase 1, and the
    look around segment ends)."""
    nrows, w = codes.shape
    flat = codes.reshape(-1)
    if steps is None:
        steps, segs = segments(nrows, w)
    else:
        chunks = w // CHUNK if w % CHUNK == 0 else (w + CHUNK - 2) // CHUNK + 1
        segs = -(-chunks // (LANES * steps))
    recs, reads = [], [0, 0]  # [own chunks, look-around chunks]
    for row in range(nrows):
        e0 = row * w
        jr0, jr1 = e0 // CHUNK, (e0 + w - 1) // CHUNK
        for seg in range(segs):
            js = jr0 + seg * steps * LANES
            if js > jr1:
                continue
            je = min(js + steps * LANES - 1, jr1)
            nsteps = (je - js) // LANES + 1
            masks = [[chunk_mask(flat, js + s * LANES + lane, e0, w, vec) if js + s * LANES + lane <= je else 0
                      for lane in range(LANES)] for s in range(nsteps)]
            reads[0] += je - js + 1
            bals = [(ballot(m, 0), ballot(m, 1)) for m in masks]
            xs, xe = max(js * CHUNK - e0, 0), min(je * CHUNK + CHUNK - 1 - e0, w - 1)
            c = none_near(k, True)
            if js > jr0:
                c = look_around(c, flat, e0, w, jr0, jr1, js, xs, clip, k, vec, True, reads)
            carry = []
            for s in range(nsteps):
                carry.append(c)
                c = take(c, masks[s], bals[s], ALL, (js + s * LANES) * CHUNK - e0, k, True)
            after = none_near(k, False)
            if je < jr1:
                after = look_around(after, flat, e0, w, jr0, jr1, je, xe, clip, k, vec, False, reads)
            for s in range(nsteps - 1, -1, -1):
                x0 = (js + s * LANES) * CHUNK - e0
                ends = []
                for lane in range(LANES):
                    below, above = (1 << lane) - 1, ~((2 << lane) - 1) & ALL
                    lo = take(carry[s], masks[s], bals[s], below, x0, k, True)
                    hi = take(after, masks[s], bals[s], above, x0, k, False)
                    if js + s * LANES + lane <= je:
                        ends.append((e0, js + s * LANES + lane, masks[s][lane], lo, hi))
                after = take(after, masks[s], bals[s], ALL, x0, k, False)
                recs.extend(ends)
    return recs, reads


def _arrays(recs):
    e0 = np.array([r[0] for r in recs], np.int64)
    j = np.array([r[1] for r in recs], np.int64)
    m = np.array([r[2] for r in recs], np.int64)
    lo = {p: np.array([r[3][p] for r in recs], np.int64) for p in (0, 1)}
    hi = {p: np.array([r[4][p] for r in recs], np.int64) for p in (0, 1)}
    return e0, j, m, lo, hi


def _scatter(planes: np.ndarray, e0, j, w: int, vals: list) -> None:
    """Write each chunk's in-row values; planes[-1] counts the writes."""
    e = j[:, None] * CHUNK + np.arange(CHUNK)
    ok = (e >= e0[:, None]) & (e < e0[:, None] + w)
    for p, v in enumerate(vals):
        planes[p].reshape(-1)[e[ok]] = v[ok]
    np.add.at(planes[-1].reshape(-1), e[ok], 1)


PAIR_MAX = 65535 - CHUNK  # the largest clip the epilogues walk two pixels a step at
HI8 = np.array([b.bit_length() - 1 for b in range(256)])  # 31 - clz of a byte
LO8 = np.array([(b & -b).bit_length() - 1 for b in range(256)])  # ffs - 1 of a byte


def step_masks(mp):
    """sel[i]: all ones in the low half where pixel i is a seed, in the
    high half where pixel i + 8 is."""
    s = (mp & 0xFF) | (mp & 0xFF00) << 8
    return [((s >> i) & 0x00010001) * 0xFFFF for i in range(8)]


def pair(lo, hi):
    return lo | hi << 16


def vminu2(a, b):
    return np.minimum(a & 0xFFFF, b & 0xFFFF) | np.minimum(a >> 16, b >> 16) << 16


def unpair(f):
    """(records, 16) pixel values of 8 pair words a record."""
    return np.stack([f[i] & 0xFFFF for i in range(8)] + [f[i] >> 16 for i in range(8)], axis=1)


def edt_pairs(mp, x0, left, right, clip):
    """edt_rows' walk two pixels a step, in 32-bit words."""
    sel = step_masks(mp)
    cl = np.minimum(x0 - 1 - left, clip)
    b = mp & 0xFF
    d = pair(cl, np.where(b > 0, 7 - HI8[b], cl + 8))
    f = []
    for i in range(8):
        d = (d + 0x00010001) & ~sel[i] & ALL
        f.append(d)
    cr = np.minimum(right - x0 - 16, clip)
    b2 = mp >> 8
    d = pair(np.where(b2 > 0, LO8[b2], cr + 8), cr)
    for i in range(7, -1, -1):
        d = (d + 0x00010001) & ~sel[i] & ALL
        f[i] = vminu2(vminu2(f[i], d), pair(clip, clip))
    return unpair(f)


def brute_pairs(mp, x0, n1, n2, sent, left: bool):
    """brute_rows' walk of one side two pixels a step: (L1 or R1, L2 or R2)."""
    sel = step_masks(mp)
    c1 = np.minimum(x0 - 1 - n1 if left else n1 - x0 - 16, sent)
    c2 = np.minimum(x0 - 1 - n2 if left else n2 - x0 - 16, sent)
    b = mp & 0xFF if left else mp >> 8
    h1 = HI8[b] if left else LO8[b]
    rest = b & ~(1 << (h1 & 31)) if left else b & (b - 1)
    h2 = HI8[rest] if left else LO8[rest]
    s1 = np.where(b > 0, 7 - h1 if left else h1, c1 + 8)
    s2 = np.where(rest > 0, 7 - h2 if left else h2, np.where(b > 0, c1 + 8, c2 + 8))
    a1, a2 = (pair(c1, s1), pair(c2, s2)) if left else (pair(s1, c1), pair(s2, c2))
    d1, d2 = [None] * 8, [None] * 8
    for i in (range(8) if left else range(7, -1, -1)):
        p1, p2 = (a1 + 0x00010001) & ALL, (a2 + 0x00010001) & ALL
        a2 = (p2 & ~sel[i] | p1 & sel[i]) & ALL
        a1 = p1 & ~sel[i] & ALL
        d1[i], d2[i] = vminu2(a1, pair(sent, sent)), vminu2(a2, pair(sent, sent))
    return unpair(d1), unpair(d2)


def edt_epilogue(recs, shape, clip: int):
    """edt_rows' epilogue: (din, dout, writes) as int64."""
    e0, j, m, lo, hi = _arrays(recs)
    x0 = j * CHUNK - e0
    planes = np.zeros((3,) + shape, np.int64)
    out = []
    for pol in (0, 1):
        mp = (m >> (16 * pol)) & 0xFFFF
        if clip <= PAIR_MAX:
            out.append(edt_pairs(mp, x0, lo[pol][:, 0], hi[pol][:, 0], clip))
            continue
        n, d = lo[pol][:, 0].copy(), np.empty((len(j), CHUNK), np.int64)
        for k in range(CHUNK):
            n = np.where((mp >> k) & 1, x0 + k, n)
            d[:, k] = x0 + k - n
        n = hi[pol][:, 0].copy()
        for k in range(CHUNK - 1, -1, -1):
            n = np.where((mp >> k) & 1, x0 + k, n)
            d[:, k] = np.minimum(np.minimum(d[:, k], n - x0 - k), clip)
        out.append(d)
    _scatter(planes, e0, j, shape[1], out)
    return planes


def brute_epilogue(recs, shape, sent: int):
    """brute_rows' epilogue: the 8 planes [polarity][L1, L2, R1, R2] and the
    writes, as int64."""
    e0, j, m, lo, hi = _arrays(recs)
    x0 = j * CHUNK - e0
    planes = np.zeros((9,) + shape, np.int64)
    vals = []
    for pol in (0, 1):
        mp = (m >> (16 * pol)) & 0xFFFF
        for before in (True, False):
            near = lo if before else hi
            vals += brute_pairs(mp, x0, near[pol][:, 0], near[pol][:, 1], sent, before)
    _scatter(planes, e0, j, shape[1], vals)
    return planes


def row_cases(w: int, seed: int) -> np.ndarray:
    """Rows of tri-state codes: random, sparse (seeds far apart), no TRUE
    seed, no seed, seeds on lane and step boundaries, a second-nearest seed
    two lanes away, 0/1 dense, all TRUE."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 3, w), np.where(rng.random(w) < 0.02, rng.integers(0, 2, w), 2),
            np.where(rng.random(w) < 0.5, 0, 2), np.full(w, 2), np.full(w, 2), np.full(w, 2),
            (rng.random(w) < 0.4).astype(np.int64), np.ones(w, np.int64)]
    for x in (0, 15, 16, 31, 32, 47, 511, 512, 513, 1023):
        if x < w:
            rows[4][x] = 1 if x % 2 else 0
    for x in (5, 53):  # chunk 1 between the two holds no seed
        if x < w:
            rows[5][x] = 1
            rows[5][w - 1 - x] = 0
    return np.stack(rows).astype(np.uint8)


def _check_edt(codes: np.ndarray, clip: int, **kw) -> np.ndarray:
    planes = edt_epilogue(walk(codes, clip, 1, **kw)[0], codes.shape, clip)
    assert (planes[2] == 1).all(), "every pixel of both strips is written once"
    pin, pout = cuda_edt.row_distances_u8_plain(torch.from_numpy(codes), clip - 1)
    np.testing.assert_array_equal(planes[0], pin.to(torch.int64).numpy())
    np.testing.assert_array_equal(planes[1], pout.to(torch.int64).numpy())
    return planes


def _check_brute(codes: np.ndarray, sent: int, **kw) -> np.ndarray:
    planes = brute_epilogue(walk(codes, sent, 2, **kw)[0], codes.shape, sent)
    assert (planes[8] == 1).all(), "every pixel of the 8 planes is written once"
    want = cuda_brute.seed_strips_plain(torch.from_numpy(codes), sent - 1).to(torch.int64).numpy()
    np.testing.assert_array_equal(planes[:8], want.reshape(planes[:8].shape))
    return planes


def test_code_flags_every_byte_in_every_place():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, size=(4, 256, 8), dtype=np.uint64)
    for k in range(4):  # byte k takes every value, the others random
        words[k] = (words[k] & ~np.uint64(0xFF << (8 * k))) | (np.arange(256, dtype=np.uint64)[:, None] << (8 * k))
    words = np.concatenate([words.reshape(-1), rng.integers(0, 1 << 32, 4096, dtype=np.uint64),
                            rng.integers(0, 3, (4096, 4), dtype=np.uint64) @ (1 << 8 * np.arange(4, dtype=np.uint64))])
    got = code_flags(words)
    b = (words[:, None] >> (8 * np.arange(4, dtype=np.uint64))) & 0xFF
    want = ((b == 1) << np.arange(4)).sum(1) | ((b == 0) << np.arange(4, 8)).sum(1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,want", [((4096, 4096), (8, 1)), ((1024, 4096), (4, 2)), ((4104, 128), (1, 1)),
                                        ((64, 1100), (1, 3)), ((3, 20000), (1, 40)), ((5000, 17), (1, 1))])
def test_segments_fill_the_card(shape, want):
    """A 4096-wide row is one warp's segment; a (4,) shard's 1024 rows are
    cut in two; narrow launches go to one-step segments."""
    assert segments(*shape) == want


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("clip", [1, 255, 256, 65535])
def test_edt_rows_walk_matches_plain(w, clip):
    codes = row_cases(w, w + clip)
    _check_edt(codes, clip)
    _check_edt(codes, clip, vec=False)
    _check_edt(codes, clip, steps=STEPS)  # one segment a row: carries across steps


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("sent", [2, 255, 256, 32767])
def test_brute_rows_walk_matches_plain(w, sent):
    codes = row_cases(w, 7 * w + sent)
    _check_brute(codes, sent)
    _check_brute(codes, sent, vec=False)
    _check_brute(codes, sent, steps=STEPS)


def test_look_around_reads_stop_at_the_clip():
    """A 1100-wide launch of 8 rows cuts each row into 3 segments; with no
    seed at all the look around reads only the chunks within the clip."""
    codes = np.full((8, 1100), 2, np.uint8)
    own = sum((r * 1100 + 1099) // CHUNK - r * 1100 // CHUNK + 1 for r in range(8))
    for clip, most in ((1, 2), (67, 6), (65535, 64)):
        _, reads = walk(codes, clip, 1)
        assert reads[0] == own  # phase 1 reads each chunk of each row once
        assert 0 < reads[1] <= 8 * 4 * most  # 4 look-arounds a row


def test_walks_at_the_largest_size():
    codes = np.concatenate([row_cases(1100, 3)] * 8)  # 64 x 1100
    _check_edt(codes, 67)
    _check_brute(codes, 65)


def test_edt_rows_walk_matches_pallas():
    w = 1100
    codes = row_cases(w, 11 * w)
    planes = _check_edt(codes, 67)
    jin, jout = pallas_edt.row_distances_u8(jnp.asarray(codes), 66, interpret=True)
    np.testing.assert_array_equal(planes[0], np.asarray(jin))
    np.testing.assert_array_equal(planes[1], np.asarray(jout))


def test_edt_rows_walk_u16_matches_pallas_ext():
    b = np.random.default_rng(5).random((16, 513)) < 0.004
    planes = _check_edt(b.astype(np.uint8), 301)
    jin, jout, off = pallas_edt.row_distances_u8_ext(jnp.asarray(b), 300, interpret=True, dtype=jnp.uint16)
    np.testing.assert_array_equal(planes[0], np.asarray(jin)[off: off + 16, :513])
    np.testing.assert_array_equal(planes[1], np.asarray(jout)[off: off + 16, :513])


def test_brute_rows_walk_matches_jax():
    w, sent = 1100, 256
    codes = row_cases(w, 13 * w)
    planes = _check_brute(codes, sent)
    for pol, code in enumerate((1, 0)):
        want = jbrute.row_seed_distances(jnp.asarray(codes == code), sent)
        for k in range(4):
            np.testing.assert_array_equal(planes[4 * pol + k], np.asarray(want[k]))
