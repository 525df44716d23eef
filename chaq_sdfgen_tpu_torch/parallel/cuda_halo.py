"""The ``rdma`` halo exchange (chaq_sdfgen_tpu/parallel/pallas_halo.py):
one kernel (csrc/halo.cu) that runs a table of copy jobs, its two
launchers named after the TPU kernels, and the exchange built on them.

  halo_slab        each shard receives the ``band`` boundary rows of its
                   two neighbours, ``fill`` beyond the image (launcher
                   ``halo_slab``, for pallas_halo._halo_kernel);
  halo_ring_shift  each shard receives the whole block of its neighbour on
                   each chain, a periodic ring (launcher
                   ``halo_ring_shift``, for pallas_halo._ring_shift_kernel);
  halo_frames_rdma  the halo'd frames [up | block | down] on every line of
                   a mesh (parallel/halo.plan's runs), written in place by
                   one launch a device: ``halo_slab`` where the band fits
                   in a shard, else ``halo_ring_shift``, every hop of the
                   multi-hop chain (pallas_halo._rdma_halo_fwd_impl) in the
                   same launch, its jobs reading the blocks that hold the
                   rows; where the lines cross processes, the rows of
                   other processes' shards come by point-to-point
                   (halo.receive_legs). Differentiable: its VJP
                   (pallas_halo._rdma_halo_bwd) gathers each halo's
                   cotangent through the same launchers and adds it to its
                   owner's rows, in halo._scatter's order;
  halo_frames_rdma_many  the frames of several arrays of one shape (each
                   with its fill) in the same launches;
  exchange_row_halo_rdma(_many)  the same on a chain of blocks.

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
from chaq_sdfgen_tpu_torch.parallel import halo
from chaq_sdfgen_tpu_torch.parallel.mesh import mesh_array

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


def _frames(plan, arrays: Sequence[Sequence[torch.Tensor]], band: int, fills: Sequence) -> tuple:
    """Each array's frames [band | block | band] of the local blocks of a
    plan (halo.plan): the crossing legs by point-to-point, then per device
    one table of every array's runs (the local blocks, received slabs and
    the fill) written in place: ``halo_slab`` where band <= H_local, else
    ``halo_ring_shift``, every hop in the same launch. Returns the frames
    and the exchange's number (halo.receive_legs)."""
    bufs, seq = halo.receive_legs(plan, arrays)
    g0 = arrays[0][0]
    h, w = g0.shape[-2:]
    p = h + 2 * band
    n_img, row_bytes = _img_and_row_bytes(g0)
    frames = [[torch.empty(g.shape[:-2] + (p, w), dtype=g.dtype, device=g.device) for g in blocks]
              for blocks in arrays]
    kernel = "halo_slab" if band <= h else "halo_ring_shift"
    groups = _by_device(arrays[0])
    for device, idx in groups.items():
        jobs = []
        for blocks, fr, bf, fill in zip(arrays, frames, bufs, fills):
            for i in idx:
                for dst, cnt, kind, ref, src in plan.segs[i]:
                    if kind == halo.FILL:
                        jobs.append((None, 0, 1, fr[i], dst, p, cnt, fill))
                    elif kind == halo.LOCAL:
                        jobs.append((blocks[ref], src, h, fr[i], dst, p, cnt, None))
                    else:
                        jobs.append((bf[ref], src, bf[ref].shape[-2], fr[i], dst, p, cnt, None))
        _run(kernel, jobs, n_img, row_bytes, device, len(groups) == 1)
    return frames, seq


def _rdma_vjp(plan, cts: Sequence[torch.Tensor], band: int, meta: Sequence[tuple], seq: int) -> List[torch.Tensor]:
    """The exchange's VJP (pallas_halo._rdma_halo_bwd): per device one
    launch copies each frame's cotangent of its own rows into its block's
    gradient and every other run that read a block or a received slab into
    one scratch; the scratch's runs are added onto their owners' rows and
    onto the received slabs' cotangents in the plan's order (halo._scatter's
    order), which go back to their senders by point-to-point and are added
    there (halo.return_legs, halo.add_returned)."""
    h = plan.h
    cts = [c.contiguous() for c in cts]
    g0 = cts[0]
    p, w = g0.shape[-2:]
    n_img, row_bytes = _img_and_row_bytes(g0)
    dbufs = halo.leg_zeros(plan, meta)
    own_at = [band] * len(cts)
    extra: dict = {}  # destination device -> [(frame, dst, count, kind, ref, src)]
    for i, segs in enumerate(plan.segs):
        for seg in segs:
            dst, cnt, kind, ref, src = seg
            if plan.is_own(i, seg):
                own_at[i] = dst
            elif kind != halo.FILL:
                dev = meta[ref][2] if kind == halo.LOCAL else dbufs[ref].device
                extra.setdefault(dev, []).append((i, dst, cnt, kind, ref, src))
    kernel = "halo_slab" if band <= h else "halo_ring_shift"
    groups = _by_device(cts)
    dgs, scratch = [None] * len(cts), {}
    for device, idx in groups.items():
        own = torch.empty((len(idx),) + g0.shape[:-2] + (h, w), dtype=g0.dtype, device=device)
        runs = extra.get(device, [])
        rows = sum(r[2] for r in runs)
        sc = torch.empty(g0.shape[:-2] + (rows, w), dtype=g0.dtype, device=device)
        jobs = [(cts[i], own_at[i], p, own, k * n_img * h, h, h, None) for k, i in enumerate(idx)]
        at = 0
        for i, dst, cnt, _, _, _ in runs:
            jobs.append((cts[i], dst, p, sc, at, rows, cnt, None))
            at += cnt
        _run(kernel, jobs, n_img, row_bytes, device, len(groups) == 1)
        for k, i in enumerate(idx):
            dgs[i] = own[k]
        scratch[device] = sc
    for device, runs in extra.items():
        at = 0
        for _, _, cnt, kind, ref, src in runs:
            target = dgs[ref] if kind == halo.LOCAL else dbufs[ref]
            target.narrow(-2, src, cnt).add_(scratch[device].narrow(-2, at, cnt))
            at += cnt
    if plan.legs:
        halo.add_returned(plan, dgs, halo.return_legs(plan, dbufs, meta, seq))
    return dgs


class _RdmaHalo(torch.autograd.Function):
    """halo_frames_rdma under autograd: the forward's frames through the
    legs and the kernel, the backward _rdma_vjp (the kernel and the legs
    reversed)."""

    @staticmethod
    def forward(ctx, plan, band, fill, *blocks):
        ctx.plan, ctx.band = plan, band
        ctx.meta = [(b.shape, b.dtype, b.device) for b in blocks]
        frames, ctx.seq = _frames(plan, [blocks], band, [fill])
        return tuple(frames[0])

    @staticmethod
    def backward(ctx, *cts):
        cts = [torch.zeros(shape[:-2] + (shape[-2] + 2 * ctx.band, shape[-1]), dtype=dtype, device=device)
               if c is None else c for c, (shape, dtype, device) in zip(cts, ctx.meta)]
        return (None, None, None, *_rdma_vjp(ctx.plan, cts, ctx.band, ctx.meta, ctx.seq))


def _frames_of(flats: Sequence[Sequence[torch.Tensor]], plan_of, band: int, fills: Sequence) -> list:
    """Each array's frames of its local blocks (flat lists of one shape
    and type), ``plan_of(h)`` the exchange's halo.Plan for shards of h
    rows: differentiable, one node an array, where a block needs a
    gradient, else every array's legs in one p2p and its frames in the
    same launches."""
    if band < 0:
        raise ValueError(f"exchange_row_halo_rdma: negative band {band}")
    flats = [[g.contiguous() for g in fl] for fl in flats]
    _check_blocks("exchange_row_halo_rdma", [g for fl in flats for g in fl])
    h = flats[0][0].shape[-2]
    plan = plan_of(h)
    if torch.is_grad_enabled() and any(g.requires_grad for fl in flats for g in fl):
        return [list(_RdmaHalo.apply(plan, int(band), fill, *fl)) for fl, fill in zip(flats, fills)]
    return _frames(plan, flats, band, fills)[0]


def halo_frames_rdma(blocks: np.ndarray, mesh, axis: str, band: int, fill) -> np.ndarray:
    """halo.halo_frames (rows) through the kernel, differentiable: every
    frame of a device written by one launch whose jobs read the local
    blocks, the slabs received from other processes where the lines cross
    them, and the fill; its VJP gathers the halo rows' cotangents by one
    launch a device, adds them on their owners' rows and returns the
    received rows' cotangents to their senders."""
    return halo_frames_rdma_many([blocks], mesh, axis, band, [fill])[0]


def halo_frames_rdma_many(arrays: Sequence[np.ndarray], mesh, axis: str, band: int, fills: Sequence) -> list:
    """halo.halo_frames_many through the kernel: every array's legs in one
    p2p and every frame of a device in one launch."""
    frames = _frames_of([list(a.flat) for a in arrays],
                        lambda h: halo.plan(mesh, axis, h, [(-band, h + 2 * band)], -2), band, fills)
    return [mesh_array(fr, arrays[0].shape) for fr in frames]


def exchange_row_halo_rdma_many(arrays: Sequence[Sequence[torch.Tensor]], band: int,
                                fills: Sequence) -> List[List[torch.Tensor]]:
    """Drop-in for halo.exchange_row_halo_many through the kernel, for
    chains of blocks of one shape and type (shard i of every chain on one
    device): each chain's frames, the chains' jobs in the same launch."""
    if any(len(b) != len(arrays[0]) or any(g.device != g0.device for g, g0 in zip(b, arrays[0])) for b in arrays):
        raise ValueError("exchange_row_halo_rdma: the chains' shards differ in number or device")
    n = len(arrays[0])
    return _frames_of(arrays, lambda h: halo.chain_plan(n, h, [(-band, h + 2 * band)], -2), band, fills)


def exchange_row_halo_rdma(blocks: Sequence[torch.Tensor], band: int, fill) -> List[torch.Tensor]:
    """Drop-in for halo.exchange_row_halo through the kernel: each shard's
    (..., H_local, W) block with ``band`` halo rows above and below,
    differentiable with respect to the blocks."""
    return exchange_row_halo_rdma_many([blocks], band, [fill])[0]
