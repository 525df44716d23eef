"""Halo exchange between the shards of a mesh (chaq_sdfgen_tpu/parallel/
halo.py), on per-shard blocks in mesh order.

This is the ``ppermute`` implementation: each receiving shard gathers the
rows it needs from the blocks that hold them with ``Tensor.to`` (a peer
copy by the CUDA runtime between cards; no copy between logical shards of
one device) and the edge ``fill`` where the rows lie beyond the image.
The halo of a shard reaches as many neighbours as it spans (multi-hop
where the band exceeds a shard's height), each contributing only the rows
inside the halo. The values are JAX's, whatever the schedule; this is
also the plain version that the ``rdma`` kernels (parallel/cuda_halo.py)
are held against. exchange_row_halo and exchange_row_halo_many with a few
edge rows are also the counterpart of pallas_soft_mm._edge_exchange (the
declared kernels' gray halo and their backward's edge rows of the
cotangent and the memos).

Every exchange is one ``Plan``: the runs of global rows each local shard
takes (the fill beyond the image, rows of a local block, or rows that
another process sends), computed alike in every process from the global
layout, the shard height and the row ranges each shard takes, multi-hop
included; nothing is negotiated at run time. ``halo_frames``,
``halo_frames_many`` and ``shifted_slabs`` run one on every line of a
mesh along an axis; the chain forms (``exchange_row_halo``,
``fetch_row_slab`` ...) on a 1-D mesh of the chain's blocks. Where the
lines cross the processes of a torch.distributed run (on a process's
part of a mesh that spans them, parallel/mesh.Mesh.local), the Plan's
legs are the counterpart of ``ppermute`` across hosts: all of an
exchange's legs are posted in one
``batch_isend_irecv`` (``p2p``); rows beyond the image are the fill and
are never shipped. Under autograd the exchange is one node over every
local block, whose backward (ppermute's transpose) adds each taken row's
cotangent onto its owner's row: a shard's own rows first, then the other
runs in the Plan's order, then the cotangents that other processes return
for the rows they received; the fill takes none.
"""

from __future__ import annotations

import functools
import itertools
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.parallel.mesh import Mesh, mesh_array

# ------------------------------------------------------------ the plan

FILL, LOCAL, RECV = 0, 1, 2


def _runs_of(start: int, count: int, h: int, total: int):
    """The runs of global rows [start, start + count) of a chain of shards
    ``h`` rows each, ``total`` in all: (y0, y1, shard), shard None beyond
    the image."""
    y, end = start, start + count
    while y < end:
        if y < 0 or y >= total:
            nxt = min(end, 0) if y < 0 else end
            yield y, nxt, None
        else:
            nxt = min(end, (y // h + 1) * h)
            yield y, nxt, y // h
        y = nxt


class Plan:
    """One exchange along axis ``k`` of this process's part of a mesh: the
    global mesh's ``shape`` and the process of each entry (``processes``,
    flat), this process's rank ``me``, its part's ``local_shape`` and
    ``offset`` in the global mesh, the shard height ``h`` along ``dim``
    and the ``pieces`` each shard takes, (start, count) row ranges
    relative to its own first row (a halo'd frame is (-band, h + 2 band)).

    ``legs``: every crossing leg of the run, in one order: (line, sender,
    receiver, lo, hi), the hull of the global rows [lo, hi) of the
    sender's shards on that line that the receiver's shards read (rows
    beyond the image are no leg: the receiver writes the fill); none where
    no line crosses processes. ``segs``: for each local block (flat order)
    and piece, its runs (dst_off, count, kind, ref, src_off): the fill,
    rows of local block ref, or rows of leg ref's buffer. ``sends``: for
    each leg this process sends, the (local block, row0, count) runs that
    make its slab."""

    def __init__(self, shape: Tuple[int, ...], processes: Tuple[int, ...], k: int, me: int,
                 local_shape: Tuple[int, ...], offset: Tuple[int, ...], h: int,
                 pieces: Tuple[Tuple[int, int], ...], dim: int):
        n = shape[k]
        total = n * h
        procs = np.asarray(processes).reshape(shape)
        others = shape[:k] + shape[k + 1 :]
        owners = [[int(procs[o[:k] + (i,) + o[k:]]) for i in range(n)] for o in np.ndindex(*others)]
        hull = {}
        for li, own in enumerate(owners):
            for g in range(n):
                for start, count in pieces:
                    for y0, y1, s in _runs_of(g * h + start, count, h, total):
                        if s is not None and own[s] != own[g]:
                            key = (li, own[s], own[g])
                            lo, hi = hull.get(key, (y0, y1))
                            hull[key] = (min(lo, y0), max(hi, y1))
        self.legs = [(li, snd, rcv, lo, hi) for (li, snd, rcv), (lo, hi) in sorted(hull.items())]
        self.me, self.dim, self.h, self.n_pieces = me, dim, h, len(pieces)
        leg_of = {leg[:3]: j for j, leg in enumerate(self.legs)}

        local = list(np.ndindex(*local_shape))
        flat = {idx: f for f, idx in enumerate(local)}
        line_of, first_on = [], {}
        for f, idx in enumerate(local):
            pos = tuple(i + o for i, o in zip(idx, offset))
            li = int(np.ravel_multi_index(pos[:k] + pos[k + 1 :], others)) if others else 0
            line_of.append((li, pos[k], idx))
            first_on.setdefault(li, f)
        self.leg_block = {j: first_on[leg[0]] for j, leg in enumerate(self.legs) if leg[2] == me}

        def block_at(idx, s):  # the local flat index of shard s on idx's line
            return flat[idx[:k] + (s - offset[k],) + idx[k + 1 :]]

        self.segs = []
        for li, g, idx in line_of:
            own = owners[li]
            for start, count in pieces:
                segs, dst = [], 0
                for y0, y1, s in _runs_of(g * h + start, count, h, total):
                    if s is None:
                        segs.append((dst, y1 - y0, FILL, None, 0))
                    elif own[s] == me:
                        segs.append((dst, y1 - y0, LOCAL, block_at(idx, s), y0 - s * h))
                    else:
                        j = leg_of[(li, own[s], me)]
                        segs.append((dst, y1 - y0, RECV, j, y0 - self.legs[j][3]))
                    dst += y1 - y0
                self.segs.append(segs)
        self.sends = {j: [(block_at(line_of[first_on[li]][2], s), y0 - s * h, y1 - y0)
                          for y0, y1, s in _runs_of(lo, hi - lo, h, total)]
                      for j, (li, snd, _, lo, hi) in enumerate(self.legs) if snd == me}

    def is_own(self, p: int, seg: tuple) -> bool:
        """Whether run ``seg`` of (block, piece) ``p`` is the block's own
        rows, all of them."""
        _, cnt, kind, ref, src = seg
        return kind == LOCAL and ref == p // self.n_pieces and src == 0 and cnt == self.h

    def leg_shape(self, block_shape: Sequence[int], j: int) -> Tuple[int, ...]:
        """The shape of leg j's slab, of blocks of ``block_shape``."""
        shape = list(block_shape)
        shape[self.dim] = self.legs[j][4] - self.legs[j][3]
        return tuple(shape)

    def slab(self, blocks: Sequence[torch.Tensor], j: int) -> torch.Tensor:
        """The rows of leg j that this process sends, from its blocks."""
        parts = [blocks[f].narrow(self.dim, r0, c) for f, r0, c in self.sends[j]]
        dev = parts[0].device
        return torch.cat([p.to(dev) for p in parts], dim=self.dim).contiguous()


_plan = functools.lru_cache(maxsize=512)(Plan)


def plan(mesh: Mesh, axis: str, h: int, pieces: Sequence[Tuple[int, int]], dim: int) -> Plan:
    """The Plan of an exchange along ``axis`` of ``mesh`` (this process's
    part where the mesh spans processes), built once a layout."""
    origin = mesh.origin or mesh
    return _plan(origin.devices.shape, tuple(int(p) for p in origin.processes.flat), mesh.axis_names.index(axis),
                 mesh.process, mesh.devices.shape, mesh.offset, int(h), tuple(pieces), dim)


def chain_plan(n: int, h: int, pieces: Sequence[Tuple[int, int]], dim: int) -> Plan:
    """The Plan of an exchange along a chain of ``n`` blocks of one
    process (a 1-D mesh)."""
    return _plan((n,), (0,) * n, 0, 0, (n,), (0,), int(h), tuple(pieces), dim)


# ------------------------------------------------------------ across processes

# the host's share of the crossing legs: exchanges, legs, bytes and the
# seconds spent posting, waiting and staging (p2p)
P2P = {"exchanges": 0, "legs": 0, "bytes": 0, "seconds": 0.0}

# the crossing exchanges in the order this process makes their forwards,
# which every process makes alike; an exchange's tags carry its number, so
# that its backward's legs match only each other whatever order autograd
# runs backward nodes in
_SEQ = itertools.count()
_TAG_BITS = 12  # the tags of one exchange: leg x array (forward), leg + 2^11 (backward)


def _tag(seq: int, local: int) -> int:
    if not 0 <= local < 1 << _TAG_BITS:
        raise ValueError(f"an exchange of {local + 1} tags: more than a tag field takes")
    return ((seq % (1 << 18)) << _TAG_BITS) | local


def p2p(ops: Sequence[tuple]) -> List[torch.Tensor]:
    """Post ``ops``, each ("send" or "recv", peer, tag, tensor), in one
    torch.distributed.batch_isend_irecv and wait for them; returns the
    received tensors in order (each like its op's tensor: shape, type and
    device). gloo hands a tensor's pointer to its transport, which reads
    host memory (a CUDA tensor's send dies in writev), so under gloo a CUDA
    tensor travels through a pinned host buffer; under any other backend
    (NCCL) the card tensors themselves are posted, on this process's
    current card (one batch coalesces on one device). A failure raises:
    nothing is swapped in."""
    if not ops:
        return []
    dist = torch.distributed
    t0 = time.perf_counter()
    stage = dist.get_backend() == "gloo"
    card = None if stage else torch.device("cuda", torch.cuda.current_device())
    posted, wires = [], []
    for kind, peer, tag, t in ops:
        wire = t
        if stage and t.is_cuda:
            wire = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        elif not stage and t.is_cuda and t.device != card:
            wire = torch.empty(t.shape, dtype=t.dtype, device=card)
        if wire is not t and kind == "send":
            wire.copy_(t)
        posted.append(dist.P2POp(dist.isend if kind == "send" else dist.irecv, wire, peer, tag=tag))
        wires.append(wire)
    for req in dist.batch_isend_irecv(posted):
        req.wait()
    out = [wire.to(t.device, non_blocking=True) if wire is not t else t
           for (kind, _, _, t), wire in zip(ops, wires) if kind == "recv"]
    P2P["exchanges"] += 1
    P2P["legs"] += len(ops)
    P2P["bytes"] += sum(t.numel() * t.element_size() for _, _, _, t in ops)
    P2P["seconds"] += time.perf_counter() - t0
    return out


def receive_legs(plan: Plan, arrays: Sequence[Sequence[torch.Tensor]]) -> Tuple[List[dict], int]:
    """The crossing legs of ``plan`` for each array of local blocks (flat,
    one shape and type per array), in one p2p: sends this process's slabs;
    returns, for each array, {leg: its received buffer, on the device of
    the first local block of the leg's line}, and the exchange's number
    (its backward's tags)."""
    if not plan.legs:
        return [{} for _ in arrays], -1
    seq = next(_SEQ)
    ops, keys = [], []
    for j, (_, snd, rcv, _, _) in enumerate(plan.legs):
        for a, blocks in enumerate(arrays):
            tag = _tag(seq, j * len(arrays) + a)
            if snd == plan.me:
                ops.append(("send", rcv, tag, plan.slab(blocks, j)))
            elif rcv == plan.me:
                like = blocks[plan.leg_block[j]]
                ops.append(("recv", snd, tag, like.new_empty(plan.leg_shape(like.shape, j))))
                keys.append((a, j))
    bufs = [{} for _ in arrays]
    for (a, j), t in zip(keys, p2p(ops)):
        bufs[a][j] = t
    return bufs, seq


def return_legs(plan: Plan, dbufs: dict, blocks_meta: Sequence[tuple], seq: int) -> dict:
    """The reverse of receive_legs (exchange ``seq``) for one array: sends
    each received leg's cotangent ``dbufs[leg]`` back to its sender and
    returns {leg: the cotangent of each slab this process sent}."""
    ops, keys = [], []
    back = 1 << (_TAG_BITS - 1)
    for j, (_, snd, rcv, _, _) in enumerate(plan.legs):
        if rcv == plan.me:
            ops.append(("send", snd, _tag(seq, back + j), dbufs[j].contiguous()))
        elif snd == plan.me:
            shape, dtype, device = blocks_meta[plan.sends[j][0][0]]
            ops.append(("recv", rcv, _tag(seq, back + j),
                        torch.empty(plan.leg_shape(shape, j), dtype=dtype, device=device)))
            keys.append(j)
    return dict(zip(keys, p2p(ops)))


def leg_zeros(plan: Plan, meta: Sequence[tuple]) -> dict:
    """{leg: zeros of its slab} for each leg this process receives, on its
    buffer's device: the received rows' cotangents, to be added into."""
    out = {}
    for j, f in plan.leg_block.items():
        shape, dtype, device = meta[f]
        out[j] = torch.zeros(plan.leg_shape(shape, j), dtype=dtype, device=device)
    return out


def add_returned(plan: Plan, grads: Sequence[torch.Tensor], returned: dict) -> None:
    """Add the returned cotangents of the slabs this process sent onto its
    blocks' rows (the owner's add of ppermute's transpose)."""
    for j, ct in returned.items():
        off = 0
        for f, r0, c in plan.sends[j]:
            grads[f].narrow(plan.dim, r0, c).add_(ct.narrow(plan.dim, off, c).to(grads[f].device))
            off += c


# ------------------------------------------------------------ the exchange


def _assemble(plan: Plan, blocks: Sequence[torch.Tensor], bufs: dict, fill, copy: bool = False) -> List[torch.Tensor]:
    """Each (local block, piece)'s rows from the fill, local blocks and
    received buffers, on the block's device: a new tensor, or where
    ``copy`` is False and one run holds them all, a view of it."""
    dim, out = plan.dim, []
    for p, segs in enumerate(plan.segs):
        g = blocks[p // plan.n_pieces]
        parts = []
        for _, cnt, kind, ref, src in segs:
            if kind == FILL:
                shape = list(g.shape)
                shape[dim] = cnt
                parts.append(torch.full(shape, fill, dtype=g.dtype, device=g.device))
            else:
                t = blocks[ref] if kind == LOCAL else bufs[ref]
                parts.append((t if cnt == t.shape[dim] else t.narrow(dim, src, cnt)).to(g.device))
        if len(parts) == 1 and not copy:
            out.append(parts[0])
        else:
            out.append(torch.cat(parts, dim=dim) if parts else g.narrow(dim, 0, 0).clone())
    return out


def _scatter(plan: Plan, cts: Sequence[Optional[torch.Tensor]], meta: Sequence[tuple], seq: int) -> List[torch.Tensor]:
    """The transpose of _assemble and the legs (ppermute's): each local
    block's cotangent, its own rows' first, then every other run that read
    it added in the Plan's order, then the cotangents of its rows that
    other processes read, returned by point-to-point; the fill takes
    none."""
    dim = plan.dim
    grads: List[Optional[torch.Tensor]] = [None] * len(meta)
    rest = []
    for p, (segs, ct) in enumerate(zip(plan.segs, cts)):
        if ct is None:
            continue
        for seg in segs:
            if plan.is_own(p, seg):
                grads[seg[3]] = ct.narrow(dim, seg[0], seg[1]).to(meta[seg[3]][2], copy=True)
            elif seg[2] != FILL:
                rest.append((ct, seg))
    grads = [torch.zeros(m[0], dtype=m[1], device=m[2]) if g is None else g for g, m in zip(grads, meta)]
    dbufs = leg_zeros(plan, meta)
    for ct, (dst, cnt, kind, ref, src) in rest:
        t = grads[ref] if kind == LOCAL else dbufs[ref]
        t.narrow(dim, src, cnt).add_(ct.narrow(dim, dst, cnt).to(t.device))
    if plan.legs:
        add_returned(plan, grads, return_legs(plan, dbufs, meta, seq))
    return grads


class _Gather(torch.autograd.Function):
    """One exchange over every local block: forward the legs and the
    pieces, backward _scatter (ppermute's transpose, legs reversed)."""

    @staticmethod
    def forward(ctx, plan, fill, *blocks):
        ctx.plan = plan
        ctx.meta = [(b.shape, b.dtype, b.device) for b in blocks]
        bufs, ctx.seq = receive_legs(plan, [blocks])
        return tuple(_assemble(plan, blocks, bufs[0], fill, copy=True))

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, *_scatter(ctx.plan, cts, ctx.meta, ctx.seq))


def _gather(plan: Plan, flats: Sequence[Sequence[torch.Tensor]], fills: Sequence) -> list:
    """The pieces of ``plan`` for each array of local blocks (flat, each
    with its fill): for each array its (block, piece) results in the
    Plan's order. One p2p for every array's legs where none needs a
    gradient, else one autograd node an array."""
    if torch.is_grad_enabled() and any(b.requires_grad for fl in flats for b in fl):
        return [list(_Gather.apply(plan, fill, *fl)) for fl, fill in zip(flats, fills)]
    bufs, _ = receive_legs(plan, flats)
    return [_assemble(plan, fl, bf, fill) for fl, bf, fill in zip(flats, bufs, fills)]


def gather(plan: Plan, arrays: Sequence[np.ndarray], fills: Sequence) -> list:
    """_gather on mesh-shaped arrays of blocks: for each array a list of
    mesh-shaped arrays, one per piece."""
    shape, k = arrays[0].shape, plan.n_pieces
    outs = _gather(plan, [list(a.flat) for a in arrays], fills)
    return [[mesh_array(out[p::k], shape) for p in range(k)] for out in outs]


# ------------------------------------------------------------ along a mesh


def halo_frames(blocks: np.ndarray, mesh: Mesh, axis: str, band: int, fill, dim: int = -2) -> np.ndarray:
    """Each shard's block with ``band`` rows (dim -2, along a 'y' axis) or
    columns (dim -1, along 'x') of its neighbours on each side, ``fill``
    beyond the image, on every line of the mesh along ``axis``,
    differentiable; the rows of other processes' shards by point-to-point
    where the lines cross them."""
    h = blocks.flat[0].shape[dim]
    return gather(plan(mesh, axis, h, [(-band, h + 2 * band)], dim), [blocks], [fill])[0][0]


def halo_frames_many(arrays: Sequence[np.ndarray], mesh: Mesh, axis: str, band: int, fills: Sequence) -> List[np.ndarray]:
    """halo_frames (rows) of several arrays of blocks of one shape, each
    with its fill, in one exchange."""
    h = arrays[0].flat[0].shape[-2]
    return [out[0] for out in gather(plan(mesh, axis, h, [(-band, h + 2 * band)], -2), arrays, fills)]


def shifted_slabs(blocks: np.ndarray, mesh: Mesh, axis: str, offset: int, fill, dim: int = -2) -> np.ndarray:
    """Same-shape slabs shifted ``offset`` rows (dim -2) or columns (dim
    -1) on every line of the mesh along ``axis``: row y of each shard's
    slab holds global row y - offset, ``fill`` beyond the image; offset
    may be any stride of either sign (JFA's taps), multi-hop included.
    Any dtype: rows beyond the image are written as ``fill``, where JAX
    ships (g - fill) and adds fill back (exact for its integer states)."""
    h = blocks.flat[0].shape[dim]
    return gather(plan(mesh, axis, h, [(-offset, h)], dim), [blocks], [fill])[0][0]


# ------------------------------------------------------------ along a chain


def _chain(arrays: Sequence[Sequence[torch.Tensor]], pieces, fills, dim: int) -> list:
    """gather on a 1-D mesh of the chains' blocks (shard i of every chain
    on one device): for each chain a list of pieces, each a list of
    blocks."""
    h = arrays[0][0].shape[dim]
    p = chain_plan(len(arrays[0]), h, pieces(h), dim)
    k = p.n_pieces
    return [[out[i::k] for i in range(k)] for out in _gather(p, arrays, fills)]


def exchange_row_halo_parts(blocks: Sequence[torch.Tensor], band: int, fill,
                            dim: int = -2) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(from_up, from_down): for each shard of the chain, the ``band`` rows
    above it and the ``band`` rows below it, each (..., band, W), ``fill``
    beyond the image. blocks: (..., H_local, W), one per shard."""
    ups, downs = _chain([blocks], lambda h: [(-band, band), (h, band)], [fill], dim)[0]
    return ups, downs


def exchange_row_halo(blocks: Sequence[torch.Tensor], band: int, fill) -> List[torch.Tensor]:
    """Each shard's block with its halos attached: (..., H_local + 2 band, W)."""
    return exchange_row_halo_many([blocks], band, [fill])[0]


def exchange_row_halo_many(arrays: Sequence[Sequence[torch.Tensor]], band: int, fills: Sequence) -> List[List[torch.Tensor]]:
    """exchange_row_halo of several chains, each with its fill."""
    return [out[0] for out in _chain(arrays, lambda h: [(-band, h + 2 * band)], fills, -2)]


def exchange_col_halo(blocks: Sequence[torch.Tensor], band: int, fill) -> List[torch.Tensor]:
    """Column twin for a chain along the 'x' axis of a 2-D tile mesh:
    (..., H, W_local) -> (..., H, W_local + 2 band)."""
    return _chain([blocks], lambda w: [(-band, w + 2 * band)], [fill], -1)[0][0]


def fetch_row_slab(blocks: Sequence[torch.Tensor], offset: int, fill, dim: int = -2) -> List[torch.Tensor]:
    """shifted_slabs on a chain: row y of shard i's slab holds global row
    (y_global - offset), ``fill`` beyond the image."""
    return _chain([blocks], lambda h: [(-offset, h)], [fill], dim)[0][0]


def fetch_col_slab(blocks: Sequence[torch.Tensor], offset: int, fill) -> List[torch.Tensor]:
    """Column twin of fetch_row_slab: column x of shard i's slab holds
    global column (x_global - offset)."""
    return fetch_row_slab(blocks, offset, fill, dim=-1)
