"""The ``rdma`` halo exchange (chaq_sdfgen_tpu/parallel/pallas_halo.py):
one kernel (csrc/halo.cu) that runs a table of copy jobs, its two
launchers named after the TPU kernels, and the exchange built on them.

  halo_slab        each shard receives the ``band`` boundary rows of its
                   two neighbours, ``fill`` beyond the image (launcher
                   ``halo_slab``, for pallas_halo._halo_kernel);
  halo_ring_shift  each shard receives the whole block of its neighbour on
                   each chain, a periodic ring (launcher
                   ``halo_ring_shift``, for pallas_halo._ring_shift_kernel);
  exchange_row_halo_rdma  the halo'd frames [up | block | down], written in
                   place: one ``halo_slab`` launch where the band fits in a
                   shard, else the multi-hop ring of
                   pallas_halo._rdma_halo_fwd_impl, one ``halo_ring_shift``
                   launch per hop whose jobs read the neighbour's frame;
                   differentiable: its VJP (pallas_halo._rdma_halo_bwd)
                   ships each halo's cotangent back round the reverse ring
                   through the same launchers and adds it to its owner's
                   rows;
  exchange_row_halo_rdma_many  the frames of several chains of one shape
                   (each with its fill) in the same launches.

A job is one run of rows in every image of a block: (src, src_row0,
src_rows, dst, dst_row0, dst_rows, rows, fill), where src and dst are
contiguous tensors whose images are src_rows and dst_rows rows apart, a
row offset may reach past the first image (the k-th block of a stack
allocated as one tensor), and a None src reads ``fill``. An exchange
builds one table per receiving device and launches it once on that
device's current stream (MAX_JOBS jobs a launch; a longer table takes as
few launches as that allows). Before a table that reads another card,
the stream waits once for each source device, and each remote source is
marked as used by the stream (``record_stream``). Peer access is enabled
per pair at first use; a pair without it raises (nothing is staged
through the host).

On the CPU the same tables run through ``copy_jobs_plain``, one job at a
time. For CUDA blocks the kernel launches or the call raises.
``LAUNCHES`` counts launches. halo_slab_plain and halo_ring_shift_plain
are independent plain versions, built from slices and ``Tensor.to``.
"""

from __future__ import annotations

import functools
import struct
from typing import List, Sequence, Tuple

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.ops import _build

LAUNCHES = {"halo_slab": 0, "halo_ring_shift": 0}

MAX_JOBS = 64  # csrc/halo.cu kMaxJobs: the jobs one launch takes in its parameters
_JOB = "QQiiiiiI"  # csrc/halo.cu HaloJob: src, dst, src_row0, src_rows, dst_row0, dst_rows, rows, fill_word

_NUMPY = {torch.uint8: np.uint8, torch.int8: np.int8, torch.uint16: np.uint16, torch.int16: np.int16,
          torch.float16: np.float16, torch.uint32: np.uint32, torch.int32: np.int32, torch.float32: np.float32}

_PEERS: set = set()  # (device, peer) pairs with peer access enabled


@functools.lru_cache(maxsize=None)
def _fill_word(fill, dtype: torch.dtype) -> int:
    """The element ``fill`` of ``dtype`` as bytes, repeated to 32 bits."""
    raw = np.asarray(fill).astype(_NUMPY[dtype]).tobytes()
    return int.from_bytes(raw * (4 // len(raw)), "little")


@functools.lru_cache(maxsize=None)
def _table(n: int) -> struct.Struct:
    return struct.Struct("<" + _JOB * n)


def _check_blocks(name: str, blocks: Sequence[torch.Tensor]) -> None:
    g = blocks[0]
    shape, dtype, cuda = g.shape, g.dtype, g.is_cuda
    if not (cuda or g.is_cpu):
        raise ValueError(f"{name}: unsupported device {g.device}")
    if not all(t.shape == shape and t.dtype == dtype and t.is_cuda == cuda and t.is_contiguous() for t in blocks):
        t = next(t for t in blocks if not t.is_contiguous() or (t.shape, t.dtype, t.is_cuda) != (shape, dtype, cuda))
        raise ValueError(f"{name}: blocks must be contiguous and alike; got {tuple(t.shape)} {t.dtype} on {t.device} "
                         f"(contiguous: {t.is_contiguous()}) beside {tuple(shape)} {dtype} on {g.device}")
    if g.dim() < 2:
        raise ValueError(f"{name}: expected (..., H, W) blocks, got shape {tuple(shape)}")
    if dtype not in _NUMPY:
        raise TypeError(f"{name}: elements of 1, 2 or 4 bytes, got {dtype}")


def _check_band(band: int, h: int) -> None:
    if not 1 <= band <= h:
        raise ValueError(f"halo_slab: band {band} outside [1, {h}] (the shard's height)")


def _img_and_row_bytes(g: torch.Tensor) -> Tuple[int, int]:
    h, w = g.shape[-2:]
    return g.numel() // max(h * w, 1), w * g.element_size()


def _by_device(blocks: Sequence[torch.Tensor]) -> dict:
    """{device: the indices of the shards on it, in chain order}."""
    groups: dict = {}
    for i, g in enumerate(blocks):
        groups.setdefault(g.device, []).append(i)
    return groups


def _enable_peer(device: torch.device, peer: torch.device) -> None:
    key = (device.index, peer.index)
    if key in _PEERS:
        return
    rc = _build.load().chaq_enable_peer_access(device.index, peer.index)
    if rc == -1:
        raise RuntimeError(f"{device} has no peer access to {peer}: the halo kernel needs it")
    if rc != 0:
        raise RuntimeError(f"enabling peer access from {device} to {peer} failed with cudaError {rc}")
    _PEERS.add(key)


# ------------------------------------------------------------------ job tables


def _runs(t: torch.Tensor, row0: int, pitch: int, rows: int, n_img: int) -> torch.Tensor:
    """The (n_img, rows, W) rows row0 .. row0 + rows of each image of a
    contiguous tensor whose images are ``pitch`` rows apart."""
    w = t.shape[-1]
    return t.as_strided((n_img, rows, w), (pitch * w, w, 1), t.storage_offset() + row0 * w)


def copy_jobs_plain(jobs: Sequence[tuple], n_img: int) -> None:
    """The plain executor of a job table (the kernel's function), one job
    at a time: each run of rows sliced out of its source, or filled."""
    for src, src_row0, src_rows, dst, dst_row0, dst_rows, rows, fill in jobs:
        out = _runs(dst, dst_row0, dst_rows, rows, n_img)
        if src is None:
            out.fill_(fill)
        else:
            out.copy_(_runs(src, src_row0, src_rows, rows, n_img))


def _run(kernel: str, jobs: List[tuple], n_img: int, row_bytes: int, device: torch.device,
         local: bool) -> None:
    """Run a job table whose destinations lie on ``device``: on the CPU
    through copy_jobs_plain, MAX_JOBS jobs at a time; on a card through
    the launcher ``kernel`` on its current stream, after every source
    device's current stream unless the chain is ``local`` (every shard on
    ``device``)."""
    if not jobs or not n_img:
        return
    if device.type == "cpu":
        for first in range(0, len(jobs), MAX_JOBS):
            copy_jobs_plain(jobs[first : first + MAX_JOBS], n_img)
        return
    remote = [] if local else [job[0] for job in jobs if job[0] is not None and job[0].device != device]
    stream = torch.cuda.current_stream(device) if remote else None
    for peer in {t.device for t in remote}:
        _enable_peer(device, peer)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(peer))
        stream.wait_event(ready)
    flat = []
    for src, src_row0, src_rows, dst, dst_row0, dst_rows, rows, fill in jobs:
        flat.extend((0 if src is None else src.data_ptr(), dst.data_ptr(), src_row0, src_rows, dst_row0,
                     dst_rows, rows, 0 if src is not None else _fill_word(fill, dst.dtype)))
    _build.launch(f"chaq_{kernel}", device, _table(len(jobs)).pack(*flat), len(jobs), n_img, row_bytes)
    LAUNCHES[kernel] += -(-len(jobs) // MAX_JOBS)
    for t in {id(t): t for t in remote}.values():
        t.record_stream(stream)


# ------------------------------------------------------------------ halo_slab


def halo_slab_plain(blocks: Sequence[torch.Tensor], band: int, fill):
    """Plain halo_slab on any device: (ups, downs)."""
    n, h = len(blocks), blocks[0].shape[-2]
    _check_band(band, h)
    full = lambda g: torch.full(g.shape[:-2] + (band, g.shape[-1]), fill, dtype=g.dtype,  # noqa: E731
                                device=g.device)
    ups = [blocks[i - 1][..., h - band:, :].to(g.device, copy=True) if i > 0 else full(g)
           for i, g in enumerate(blocks)]
    downs = [blocks[i + 1][..., :band, :].to(g.device, copy=True) if i < n - 1 else full(g)
             for i, g in enumerate(blocks)]
    return ups, downs


def halo_slab(blocks: Sequence[torch.Tensor], band: int, fill) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(ups, downs) for a chain of (..., H_local, W) blocks, 1 <= band <=
    H_local: up_i holds the last ``band`` rows of block i - 1 and down_i the
    first ``band`` rows of block i + 1, each (..., band, W) on block i's
    device, ``fill`` for the first shard's up and the last one's down.
    Per device one (2, shards, ..., band, W) allocation, whose views it
    returns, and one ``halo_slab`` launch of 2 jobs a shard."""
    _check_blocks("halo_slab", blocks)
    n, g0 = len(blocks), blocks[0]
    h = g0.shape[-2]
    _check_band(band, h)
    n_img, row_bytes = _img_and_row_bytes(g0)
    slab = n_img * band  # rows a slab takes in the allocation
    ups, downs = [None] * n, [None] * n
    groups = _by_device(blocks)
    for device, idx in groups.items():
        m = len(idx)
        out = torch.empty((2, m) + g0.shape[:-2] + (band, g0.shape[-1]), dtype=g0.dtype, device=device)
        jobs = []
        for k, i in enumerate(idx):
            jobs.append((blocks[i - 1] if i > 0 else None, h - band, h, out, k * slab, band, band, fill))
            jobs.append((blocks[i + 1] if i < n - 1 else None, 0, h, out, (m + k) * slab, band, band, fill))
        _run("halo_slab", jobs, n_img, row_bytes, device, len(groups) == 1)
        u, d = out.unbind(0)
        for i, a, b in zip(idx, u.unbind(0), d.unbind(0)):
            ups[i], downs[i] = a, b
    return ups, downs


# ------------------------------------------------------------ halo_ring_shift


def halo_ring_shift_plain(ups: Sequence[torch.Tensor], downs: Sequence[torch.Tensor]):
    """Plain halo_ring_shift on any device."""
    n = len(ups)
    return ([ups[(i - 1) % n].to(ups[i].device, copy=True) for i in range(n)],
            [downs[(i + 1) % n].to(downs[i].device, copy=True) for i in range(n)])


def halo_ring_shift(ups: Sequence[torch.Tensor], downs: Sequence[torch.Tensor]):
    """One ring step each way on two chains of same-shape blocks: shard i
    receives ups[i - 1] and downs[i + 1], indices modulo the chain (the
    ring is periodic: the caller masks). Per device one (2, shards, ...)
    allocation, whose views it returns, and one ``halo_ring_shift`` launch
    of 2 jobs a shard."""
    _check_blocks("halo_ring_shift", ups)
    _check_blocks("halo_ring_shift", downs)
    if downs[0].shape != ups[0].shape or downs[0].dtype != ups[0].dtype or len(downs) != len(ups):
        raise ValueError("halo_ring_shift: the two chains differ in length, shape or type")
    n, g0 = len(ups), ups[0]
    h = g0.shape[-2]
    n_img, row_bytes = _img_and_row_bytes(g0)
    blk = n_img * h
    out_up, out_dn = [None] * n, [None] * n
    groups = _by_device(ups)
    for device, idx in groups.items():
        if any(downs[i].device != device for i in idx):
            raise ValueError("halo_ring_shift: shard i's two blocks lie on two devices")
        m = len(idx)
        out = torch.empty((2, m) + tuple(g0.shape), dtype=g0.dtype, device=device)
        jobs = []
        for k, i in enumerate(idx):
            jobs.append((ups[(i - 1) % n], 0, h, out, k * blk, h, h, None))
            jobs.append((downs[(i + 1) % n], 0, h, out, (m + k) * blk, h, h, None))
        _run("halo_ring_shift", jobs, n_img, row_bytes, device, len(groups) == 1)
        u, d = out.unbind(0)
        for i, a, b in zip(idx, u.unbind(0), d.unbind(0)):
            out_up[i], out_dn[i] = a, b
    return out_up, out_dn


# ------------------------------------------------------------------ frames


def _frame_jobs(blocks, frames, fill, i: int, hop: int, band: int, h: int) -> list:
    """Shard i's jobs of one hop (pallas_halo._rdma_halo_fwd_impl): the rows
    of block i - hop in its up halo and of block i + hop in its down halo,
    clipped to the halo, ``fill`` past the image; on the first hop from the
    neighbours' blocks, with the centre rows, on later hops from the
    neighbours' frames, where the previous hop left those blocks."""
    n, p = len(blocks), h + 2 * band
    jobs = [(blocks[i], 0, h, frames[i], band, p, h, None)] if hop == 1 else []
    start = band - hop * h  # frame row of block i - hop's first row
    lo = max(start, 0)
    if i < hop:
        src = None, 0, 1
    elif hop == 1:
        src = blocks[i - 1], lo - start, h
    else:
        src = frames[i - 1], band - (hop - 1) * h + lo - start, p
    jobs.append((*src, frames[i], lo, p, start + h - lo, fill))
    start = band + hop * h  # frame row of block i + hop's first row
    if i >= n - hop:
        src = None, 0, 1
    elif hop == 1:
        src = blocks[i + 1], 0, h
    else:
        src = frames[i + 1], start - h, p
    jobs.append((*src, frames[i], start, p, min(start + h, p) - start, fill))
    return [job for job in jobs if job[6] > 0]


def _frames(arrays: Sequence[Sequence[torch.Tensor]], band: int, fills: Sequence) -> List[List[torch.Tensor]]:
    """Each array's (..., H_local + 2 band, W) frames, allocated once per
    shard and written in place: one ``halo_slab`` launch per device where
    band <= H_local, else one ``halo_ring_shift`` launch per hop and
    device, every array's jobs in the same launches."""
    if band < 0:
        raise ValueError(f"exchange_row_halo_rdma: negative band {band}")
    g0 = arrays[0][0]
    h, w = g0.shape[-2:]
    n_img, row_bytes = _img_and_row_bytes(g0)
    frames = [[torch.empty(g.shape[:-2] + (h + 2 * band, w), dtype=g.dtype, device=g.device) for g in blocks]
              for blocks in arrays]
    hops = 1 if band <= h else -(-band // h)
    kernel = "halo_slab" if hops == 1 else "halo_ring_shift"
    groups = _by_device(arrays[0])
    for hop in range(1, hops + 1):
        for device, idx in groups.items():
            jobs = [job for blocks, fr, fill in zip(arrays, frames, fills) for i in idx
                    for job in _frame_jobs(blocks, fr, fill, i, hop, band, h)]
            _run(kernel, jobs, n_img, row_bytes, device, len(groups) == 1)
    return frames


def _rdma_halo_vjp(cts: Sequence[torch.Tensor], band: int, h: int) -> List[torch.Tensor]:
    """The exchange's VJP (pallas_halo._rdma_halo_bwd): each shard's
    cotangent of its (..., h + 2 band, W) halo'd block -> that of its (...,
    h, W) block: its own rows' part plus the halo cotangents that other
    shards hold for its rows, shipped back round the reverse ring. One hop:
    one halo_slab launch per device copies each shard's own rows and pulls
    the last ``band`` rows of shard i - 1's cotangent, its down halo, for
    its head rows and the first of shard i + 1's, its up halo, for its tail
    rows (0 beyond the image); two adds over the device's shards place
    them. Multi-hop: the hop blocks of both halos (0 where the forward read
    the fill) ride hops ring shifts the reverse way, each hop's block added
    on its way back to its owner."""
    n = len(cts)
    cts = [c.contiguous() for c in cts]
    if n == 1 or band < 1:
        return [c[..., band : band + h, :].clone() for c in cts]
    if band <= h:
        return _rdma_halo_vjp_one_hop(cts, band, h)
    dgs = [c[..., band : band + h, :].clone() for c in cts]
    hops = -(-band // h)
    pad = [c.new_zeros(c.shape[:-2] + (hops * h - band, c.shape[-1])) for c in cts]
    up_full = [torch.cat([p, c[..., :band, :]], dim=-2) for p, c in zip(pad, cts)]
    dn_full = [torch.cat([c[..., band + h :, :], p], dim=-2) for p, c in zip(pad, cts)]
    zero = cts[0].new_zeros(cts[0].shape[:-2] + (h, cts[0].shape[-1]))

    def piece_up(i, k):  # hop k's up-halo block of shard i: shard i - k's rows
        return up_full[i][..., (hops - k) * h : (hops - k + 1) * h, :] if i >= k else zero.to(cts[i].device)

    def piece_dn(i, k):  # hop k's down-halo block of shard i: shard i + k's rows
        return dn_full[i][..., (k - 1) * h : k * h, :] if i < n - k else zero.to(cts[i].device)

    # Horner over the hops: the up-halo cotangents travel toward lower
    # indices, the down-halo ones toward higher, one ring step per hop
    back_up = [piece_up(i, hops).contiguous() for i in range(n)]
    back_dn = [piece_dn(i, hops).contiguous() for i in range(n)]
    for k in range(hops - 1, -1, -1):
        back_dn, back_up = halo_ring_shift(back_dn, back_up)
        back_up[n - 1] = torch.zeros_like(back_up[n - 1])  # wrapped round the ring
        back_dn[0] = torch.zeros_like(back_dn[0])
        if k:
            back_up = [(b + piece_up(i, k)).contiguous() for i, b in enumerate(back_up)]
            back_dn = [(b + piece_dn(i, k)).contiguous() for i, b in enumerate(back_dn)]
    return [dg + u + d for dg, u, d in zip(dgs, back_up, back_dn)]


def _rdma_halo_vjp_one_hop(cts: Sequence[torch.Tensor], band: int, h: int) -> List[torch.Tensor]:
    """_rdma_halo_vjp where band <= h: per device the shards' own rows, one
    (shards, ..., h, W) tensor, and halo_slab's slabs of the cotangents, one
    (2, shards, ..., band, W) tensor, in one launch; then my tail rows plus
    shard i + 1's up halo and my head rows plus shard i - 1's down halo."""
    _check_blocks("exchange_row_halo_rdma", cts)
    n, g0 = len(cts), cts[0]
    p, w = g0.shape[-2:]
    n_img, row_bytes = _img_and_row_bytes(g0)
    dgs = [None] * n
    groups = _by_device(cts)
    for device, idx in groups.items():
        m = len(idx)
        own = torch.empty((m,) + g0.shape[:-2] + (h, w), dtype=g0.dtype, device=device)
        slabs = torch.empty((2, m) + g0.shape[:-2] + (band, w), dtype=g0.dtype, device=device)
        jobs = []
        for k, i in enumerate(idx):
            jobs.append((cts[i], band, p, own, k * n_img * h, h, h, None))
            jobs.append((cts[i - 1] if i > 0 else None, p - band, p, slabs, k * n_img * band, band, band, 0))
            jobs.append((cts[i + 1] if i < n - 1 else None, 0, p, slabs, (m + k) * n_img * band, band, band, 0))
        _run("halo_slab", jobs, n_img, row_bytes, device, len(groups) == 1)
        own[..., h - band :, :] += slabs[1]
        own[..., :band, :] += slabs[0]
        for i, dg in zip(idx, own.unbind(0)):
            dgs[i] = dg
    return dgs


class _RdmaHalo(torch.autograd.Function):
    """exchange_row_halo_rdma under autograd: the forward's frames through
    the kernel, the backward _rdma_halo_vjp (the kernel again)."""

    @staticmethod
    def forward(ctx, band, fill, *blocks):
        ctx.band, ctx.h = band, blocks[0].shape[-2]
        return tuple(_frames([blocks], band, [fill])[0])

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, *_rdma_halo_vjp(cts, ctx.band, ctx.h))


def exchange_row_halo_rdma_many(arrays: Sequence[Sequence[torch.Tensor]], band: int,
                                fills: Sequence) -> List[List[torch.Tensor]]:
    """Drop-in for [halo.exchange_row_halo(a, band, f) for a, f in zip(arrays,
    fills)] through the kernel, for chains of blocks of one shape and type
    (shard i of every chain on one device): each chain's frames, the
    chains' jobs in the same launches. Not differentiable."""
    arrays = [[g.contiguous() for g in blocks] for blocks in arrays]
    _check_blocks("exchange_row_halo_rdma", [g for blocks in arrays for g in blocks])
    if any(len(b) != len(arrays[0]) or any(g.device != g0.device for g, g0 in zip(b, arrays[0])) for b in arrays):
        raise ValueError("exchange_row_halo_rdma: the chains' shards differ in number or device")
    return _frames(arrays, band, fills)


def exchange_row_halo_rdma(blocks: Sequence[torch.Tensor], band: int, fill) -> List[torch.Tensor]:
    """Drop-in for halo.exchange_row_halo through the kernel: each shard's
    (..., H_local, W) block with ``band`` halo rows above and below,
    differentiable with respect to the blocks."""
    blocks = [g.contiguous() for g in blocks]
    _check_blocks("exchange_row_halo_rdma", blocks)
    if torch.is_grad_enabled() and any(g.requires_grad for g in blocks):
        return list(_RdmaHalo.apply(int(band), fill, *blocks))
    return _frames([blocks], band, [fill])[0]
