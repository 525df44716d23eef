"""The rdma halo exchange's job tables (chaq_sdfgen_tpu_torch/parallel/
cuda_halo.py) on the CPU, where they run through copy_jobs_plain, the
plain executor of the table that csrc/halo.cu launches on a card: the
slabs (halo_slab), the ring step (halo_ring_shift) and the halo'd frames
written in place, one hop and multi-hop, held against the ppermute form
(parallel/halo.py) and the independent plain versions, in four element
types, on plane stacks and on rows whose bytes are not a multiple of 16;
the tables' shape (one table per exchange and device, the jobs a shard
takes); the split of a table longer than a launch takes; and one case
against pallas_halo.exchange_row_halo_rdma in interpret mode."""

import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from chaq_sdfgen_tpu.parallel import mesh as jmesh
from chaq_sdfgen_tpu.parallel.pallas_halo import exchange_row_halo_rdma as j_rdma

from chaq_sdfgen_tpu_torch.parallel import cuda_halo, halo

FILLS = {torch.uint8: 255, torch.uint16: 65535, torch.int32: -1, torch.float32: -7.25}


def _blocks(n, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(0, 60000, size=shape)).to(dtype) for _ in range(n)]


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.fixture
def tables(monkeypatch):
    """Every table the exchange runs: (launcher, jobs), the tables still run."""
    seen = []
    run = cuda_halo._run

    def spy(kernel, jobs, *args):
        seen.append((kernel, len(jobs)))
        run(kernel, jobs, *args)

    monkeypatch.setattr(cuda_halo, "_run", spy)
    return seen


@pytest.mark.parametrize("dtype", list(FILLS))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("band", [1, 6, 7, 13, 15])  # 6-row shards: one hop, band = H_local, 2 and 3 hops
def test_frames_match_ppermute(dtype, n, band, tables):
    blocks = _blocks(n, (6, 9), dtype, n * band)  # 9 elements: rows of 9, 18 or 36 bytes
    fill = FILLS[dtype]
    before = dict(cuda_halo.LAUNCHES)
    _equal(cuda_halo.exchange_row_halo_rdma(blocks, band, fill), halo.exchange_row_halo(blocks, band, fill))
    assert cuda_halo.LAUNCHES == before  # CPU blocks: no launch
    hops = -(-band // 6)
    if hops == 1:
        assert tables == [("halo_slab", 3 * n)]
    else:
        # one table for every hop: a job for each shard within reach and
        # for each fill, each reading the block that holds its rows
        assert tables == [("halo_ring_shift", _frame_jobs(n, 6, band))]


def _frame_jobs(n: int, h: int, band: int) -> int:
    """The jobs of the frames of n shards of h rows at ``band``: each
    shard's own block, every block within ``band`` rows of it, and a fill
    where the halo passes an edge of the image."""
    hops = -(-band // h)
    return sum(min(n - 1, i + hops) - max(0, i - hops) + 1 + (i * h < band) + ((n - 1 - i) * h < band)
               for i in range(n))


@pytest.mark.parametrize("dtype", list(FILLS))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("band", [1, 5, 8])
def test_slabs_match_plain_and_parts(dtype, n, band, tables):
    blocks = _blocks(n, (8, 13), dtype, n + band)
    fill = FILLS[dtype]
    got = cuda_halo.halo_slab(blocks, band, fill)
    assert tables == [("halo_slab", 2 * n)]
    _equal(got[0] + got[1], sum(cuda_halo.halo_slab_plain(blocks, band, fill), []))
    _equal(got[0] + got[1], sum(halo.exchange_row_halo_parts(blocks, band, fill), []))


@pytest.mark.parametrize("dtype", list(FILLS))
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_shift_matches_plain(dtype, n, tables):
    ups, downs = _blocks(n, (5, 11), dtype, n), _blocks(n, (5, 11), dtype, n + 1)
    got = cuda_halo.halo_ring_shift(ups, downs)
    assert tables == [("halo_ring_shift", 2 * n)]
    _equal(got[0] + got[1], sum(cuda_halo.halo_ring_shift_plain(ups, downs), []))


@pytest.mark.parametrize("band", [3, 8, 11, 20])  # BRUTE's (2, 4, h, W) plane stacks, 8 images a block
def test_plane_stacks(band):
    blocks = _blocks(4, (2, 4, 8, 16), torch.uint8, band)
    _equal(cuda_halo.exchange_row_halo_rdma(blocks, band, 9), halo.exchange_row_halo(blocks, band, 9))
    if band <= 8:
        got = cuda_halo.halo_slab(blocks, band, 9)
        _equal(got[0] + got[1], sum(cuda_halo.halo_slab_plain(blocks, band, 9), []))
    got = cuda_halo.halo_ring_shift(blocks, blocks[::-1])
    _equal(got[0] + got[1], sum(cuda_halo.halo_ring_shift_plain(blocks, blocks[::-1]), []))


@pytest.mark.parametrize("band", [2, 9])
def test_three_chains_in_one_table(band, tables):
    """Tier 1a's backward: the cotangent (fill 0) and both memos (fill
    1e30) of a chain exchanged in the same launches."""
    arrays = [[b.float() for b in _blocks(4, (2, 8, 10), torch.int32, band + k)] for k in range(3)]
    fills = [0.0, 1e30, 1e30]
    got = cuda_halo.exchange_row_halo_rdma_many(arrays, band, fills)
    for g, w in zip(got, halo.exchange_row_halo_many(arrays, band, fills)):
        _equal(g, w)
    if band <= 8:
        assert tables == [("halo_slab", 3 * 3 * 4)]
    else:
        assert tables == [("halo_ring_shift", 3 * _frame_jobs(4, 8, band))] == [("halo_ring_shift", 54)]


def test_table_longer_than_a_launch(monkeypatch):
    """A table of more jobs than a launch takes runs in as few launches as
    that allows, in order, every hop in one table."""
    chunks = []
    plain = cuda_halo.copy_jobs_plain

    def spy(jobs, n_img):
        chunks.append(len(jobs))
        plain(jobs, n_img)

    monkeypatch.setattr(cuda_halo, "copy_jobs_plain", spy)
    monkeypatch.setattr(cuda_halo, "MAX_JOBS", 5)
    blocks = _blocks(8, (4, 7), torch.int32, 3)
    _equal(cuda_halo.exchange_row_halo_rdma(blocks, 3, -1), halo.exchange_row_halo(blocks, 3, -1))
    assert chunks == [5, 5, 5, 5, 4]  # 24 jobs
    chunks.clear()
    _equal(cuda_halo.exchange_row_halo_rdma(blocks, 10, -1), halo.exchange_row_halo(blocks, 10, -1))
    assert chunks == [5] * 10  # three hops, 50 jobs


@pytest.mark.parametrize("band", [3, 6, 13])  # 6-row shards: one hop, band = H_local, three hops
def test_vjp_matches_ppermute_bit_for_bit(band):
    """Both halo forms' VJPs add each block's cotangents in one order (its
    own rows first, then the other frames' runs in the plan's order), so
    their gradients are equal bit for bit, multi-hop included; the fill
    takes none."""
    rng = np.random.default_rng(band)
    x = [torch.from_numpy(rng.standard_normal((2, 6, 9)).astype(np.float32)) for _ in range(4)]
    cts = [torch.from_numpy(rng.standard_normal((2, 6 + 2 * band, 9)).astype(np.float32)) for _ in range(4)]
    grads = []
    for exchange in (cuda_halo.exchange_row_halo_rdma, halo.exchange_row_halo):
        xs = [t.clone().requires_grad_() for t in x]
        sum((e * c).sum() for e, c in zip(exchange(xs, band, -7.25), cts)).backward()
        grads.append([t.grad for t in xs])
    _equal(grads[0], grads[1])
    want = np.zeros((2, 24, 9), np.float32)
    for i, c in enumerate(cts):
        for r in range(6 + 2 * band):
            if 0 <= i * 6 - band + r < 24:
                want[:, i * 6 - band + r] += c[:, r].numpy()
    np.testing.assert_allclose(torch.cat(grads[0], dim=-2).numpy(), want, rtol=1e-6, atol=1e-6)


def test_job_packing_and_fill_words():
    assert cuda_halo._table(3).size == 3 * 40  # csrc/halo.cu: sizeof(HaloJob) == 40
    assert 64 * 40 + 16 <= 4096 and cuda_halo.MAX_JOBS == 64  # the table within the 4 KB of parameters
    assert cuda_halo._fill_word(255, torch.uint8) == 0xFFFFFFFF
    assert cuda_halo._fill_word(7, torch.uint16) == 0x00070007
    assert cuda_halo._fill_word(-1, torch.int32) == 0xFFFFFFFF
    assert cuda_halo._fill_word(-7.25, torch.float32) == struct.unpack("<I", struct.pack("<f", -7.25))[0]
    assert cuda_halo._fill_word(1e30, torch.float32) == struct.unpack("<I", struct.pack("<f", 1e30))[0]
    with pytest.raises(TypeError):
        cuda_halo.halo_slab([torch.zeros(4, 4, dtype=torch.float64)] * 2, 1, 0.0)
    with pytest.raises(ValueError):
        cuda_halo.halo_slab([torch.zeros(4, 4), torch.zeros(4, 4).t()], 1, 0.0)  # strided
    with pytest.raises(ValueError):
        cuda_halo.exchange_row_halo_rdma([torch.zeros(4, 4)] * 2, -1, 0.0)


def test_frames_match_jax_interpret():
    """Three hops over 6-row shards against pallas_halo in interpret mode
    under shard_map."""
    n, band, fill = 4, 14, -7.25
    g = np.random.default_rng(14).random((6 * n, 10)).astype(np.float32)
    f = jax.shard_map(lambda x: j_rdma(x, band, "y", fill, True), mesh=jmesh.make_mesh((n,), ("y",)),
                      in_specs=(P("y", None),), out_specs=P("y", None), check_vma=False)
    want = np.asarray(jax.jit(f)(jnp.asarray(g)))
    got = cuda_halo.exchange_row_halo_rdma([torch.from_numpy(b) for b in np.split(g, n)], band, fill)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
