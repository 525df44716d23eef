"""The ``rdma`` halo exchange (chaq_sdfgen_tpu/parallel/pallas_halo.py):
two kernels (csrc/halo.cu), each beside its plain PyTorch version, and the
exchange built on them.

  halo_slab        each shard receives the ``band`` boundary rows of its
                   two neighbours, ``fill`` beyond the image (kernel
                   ``halo_slab``, for pallas_halo._halo_kernel);
  halo_ring_shift  each shard receives the whole block of its neighbour on
                   each chain, a periodic ring (kernel ``halo_ring_shift``,
                   for pallas_halo._ring_shift_kernel);
  exchange_row_halo_rdma  the halo'd blocks, with the multi-hop chain of
                   pallas_halo._rdma_halo_fwd_impl where the band exceeds a
                   shard's height, differentiable: its VJP
                   (pallas_halo._rdma_halo_bwd) ships each halo's cotangent
                   back round the reverse ring through the same kernels and
                   adds it to its owner's rows.

A kernel runs once per receiving shard, on that shard's device and current
stream, and pulls its neighbours' rows through peer pointers. Before a
pull from another card the receiver's stream waits on an event recorded
on the source's stream, and the source block is marked as used by the
receiver's stream (``record_stream``). Peer access is enabled per pair at
first use; a pair without it raises (nothing is staged through the host).

A wrapper runs the plain version only for blocks on the CPU. For CUDA
blocks it launches the kernels or raises. ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from chaq_sdfgen_tpu_torch.ops import _build

LAUNCHES = {"halo_slab": 0, "halo_ring_shift": 0}

_PEERS: set = set()  # (device, peer) pairs with peer access enabled


def _fill_word(fill, dtype: torch.dtype) -> int:
    """The element ``fill`` of ``dtype`` as bytes, repeated to 32 bits."""
    raw = bytes(torch.full((1,), fill, dtype=dtype).view(torch.uint8).tolist())
    return int.from_bytes(raw * (4 // len(raw)), "little")


def _check_blocks(name: str, blocks: Sequence[torch.Tensor]) -> None:
    g = blocks[0]
    for t in blocks:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {t.device}")
        if t.shape != g.shape or t.dtype != g.dtype:
            raise ValueError(f"{name}: blocks of {tuple(t.shape)} {t.dtype} and {tuple(g.shape)} {g.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: blocks must be contiguous")
    if g.dim() < 2:
        raise ValueError(f"{name}: expected (..., H, W) blocks, got shape {tuple(g.shape)}")
    if g.element_size() not in (1, 2, 4):
        raise TypeError(f"{name}: elements of 1, 2 or 4 bytes, got {g.dtype}")


def _enable_peer(device: torch.device, peer: torch.device) -> None:
    key = (device.index, peer.index)
    if key in _PEERS:
        return
    rc = _build.load().chaq_enable_peer_access(device.index, peer.index)
    if rc == -1:
        raise RuntimeError(f"{device} has no peer access to {peer}: the halo kernels need it")
    if rc != 0:
        raise RuntimeError(f"enabling peer access from {device} to {peer} failed with cudaError {rc}")
    _PEERS.add(key)


def _pull(entry: str, dst: torch.Tensor, sources, *args) -> None:
    """Launch ``entry`` on dst's device and current stream after each
    source on another device is ready there, then keep those sources
    alive for that stream."""
    stream = torch.cuda.current_stream(dst.device)
    remote = [s for s in sources if s is not None and s.device != dst.device]
    for s in remote:
        _enable_peer(dst.device, s.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(s.device))
        stream.wait_event(ready)
    _build.launch(entry, dst.device, *args)
    for s in remote:
        s.record_stream(stream)


def _rows(g: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.empty(g.shape[:-2] + (rows, g.shape[-1]), dtype=g.dtype, device=g.device)


def _img_and_row_bytes(g: torch.Tensor) -> Tuple[int, int]:
    h, w = g.shape[-2:]
    return g.numel() // max(h * w, 1), w * g.element_size()


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
    Kernel ``halo_slab`` (one launch per shard) on CUDA, the plain version
    on the CPU."""
    if blocks[0].device.type == "cpu":
        return halo_slab_plain(blocks, band, fill)
    _check_blocks("halo_slab", blocks)
    n, h = len(blocks), blocks[0].shape[-2]
    _check_band(band, h)
    n_img, row_bytes = _img_and_row_bytes(blocks[0])
    word = _fill_word(fill, blocks[0].dtype)
    ups, downs = [], []
    for i, g in enumerate(blocks):
        up, down = _rows(g, band), _rows(g, band)
        src_up = blocks[i - 1] if i > 0 else None
        src_dn = blocks[i + 1] if i < n - 1 else None
        if n_img:
            _pull("chaq_halo_slab", g, (src_up, src_dn),
                  src_up.data_ptr() if src_up is not None else None,
                  src_dn.data_ptr() if src_dn is not None else None,
                  up.data_ptr(), down.data_ptr(), n_img, band, h, row_bytes, word)
            LAUNCHES["halo_slab"] += 1
        ups.append(up)
        downs.append(down)
    return ups, downs


def _check_band(band: int, h: int) -> None:
    if not 1 <= band <= h:
        raise ValueError(f"halo_slab: band {band} outside [1, {h}] (the shard's height)")


# ------------------------------------------------------------ halo_ring_shift


def halo_ring_shift_plain(ups: Sequence[torch.Tensor], downs: Sequence[torch.Tensor]):
    """Plain halo_ring_shift on any device."""
    n = len(ups)
    return ([ups[(i - 1) % n].to(ups[i].device, copy=True) for i in range(n)],
            [downs[(i + 1) % n].to(downs[i].device, copy=True) for i in range(n)])


def halo_ring_shift(ups: Sequence[torch.Tensor], downs: Sequence[torch.Tensor]):
    """One ring step each way on two chains of same-shape blocks: shard i
    receives ups[i - 1] and downs[i + 1], indices modulo the chain (the
    ring is periodic: the caller masks). Kernel ``halo_ring_shift`` (one
    launch per shard) on CUDA, the plain version on the CPU."""
    if ups[0].device.type == "cpu":
        return halo_ring_shift_plain(ups, downs)
    _check_blocks("halo_ring_shift", list(ups) + list(downs))
    n = len(ups)
    n_img, row_bytes = _img_and_row_bytes(ups[0])
    out_up, out_dn = [], []
    for i in range(n):
        up, down = torch.empty_like(ups[i]), torch.empty_like(downs[i])
        if ups[i].device != downs[i].device:
            raise ValueError("halo_ring_shift: shard i's two blocks lie on two devices")
        src_up, src_dn = ups[(i - 1) % n], downs[(i + 1) % n]
        if n_img:
            _pull("chaq_halo_ring_shift", up, (src_up, src_dn), src_up.data_ptr(), src_dn.data_ptr(),
                  up.data_ptr(), down.data_ptr(), n_img, ups[i].shape[-2], row_bytes)
            LAUNCHES["halo_ring_shift"] += 1
        out_up.append(up)
        out_dn.append(down)
    return out_up, out_dn


# ------------------------------------------------------------------ exchange


def exchange_row_halo_rdma_parts(blocks: Sequence[torch.Tensor], band: int, fill):
    """(from_up, from_down) as halo.exchange_row_halo_parts, through the
    kernels: one halo_slab where band <= H_local, else ``hops`` ring shifts
    of whole blocks, each hop's wrapped edge replaced by ``fill``, as
    pallas_halo._rdma_halo_fwd_impl (:161-184). Not differentiable (the
    halos are new tensors): exchange_row_halo_rdma is."""
    n, h = len(blocks), blocks[0].shape[-2]
    full = lambda g, rows: torch.full(g.shape[:-2] + (rows, g.shape[-1]), fill,  # noqa: E731
                                      dtype=g.dtype, device=g.device)
    if band < 1:
        return [full(g, 0) for g in blocks], [full(g, 0) for g in blocks]
    if n == 1:
        return [full(blocks[0], band)], [full(blocks[0], band)]
    if band <= h:
        return halo_slab(blocks, band, fill)
    hops = -(-band // h)
    cur_up, cur_dn = list(blocks), list(blocks)
    up_parts = [[] for _ in range(n)]
    down_parts = [[] for _ in range(n)]
    for hop in range(1, hops + 1):
        cur_up, cur_dn = halo_ring_shift(cur_up, cur_dn)
        for i in range(n):
            up_parts[i].insert(0, cur_up[i] if i >= hop else full(cur_up[i], h))
            down_parts[i].append(cur_dn[i] if i < n - hop else full(cur_dn[i], h))
    ups = [torch.cat(p, dim=-2)[..., hops * h - band:, :] for p in up_parts]
    downs = [torch.cat(p, dim=-2)[..., :band, :] for p in down_parts]
    return ups, downs


def _rdma_halo_vjp(cts: Sequence[torch.Tensor], band: int, h: int) -> List[torch.Tensor]:
    """The exchange's VJP (pallas_halo._rdma_halo_bwd): each shard's
    cotangent of its (..., h + 2 band, W) halo'd block -> that of its (...,
    h, W) block: its own rows' part plus the halo cotangents that other
    shards hold for its rows, shipped back round the reverse ring. One hop:
    halo_slab on the halo'd cotangents (shard i pulls the last ``band`` rows
    of shard i - 1's, its down halo, for its head rows, and the first of
    shard i + 1's, its up halo, for its tail rows; 0 beyond the image).
    Multi-hop: the hop blocks of both halos (0 where the forward read the
    fill) ride hops ring shifts the reverse way, each hop's block added on
    its way back to its owner."""
    n = len(cts)
    cts = [c.contiguous() for c in cts]
    dgs = [c[..., band : band + h, :].clone() for c in cts]
    if n == 1 or band < 1:
        return dgs
    if band <= h:
        from_up, from_down = halo_slab(cts, band, 0)
        for dg, u, d in zip(dgs, from_up, from_down):
            dg[..., h - band :, :] += d  # my tail rows, from shard i + 1's up halo
            dg[..., :band, :] += u  # my head rows, from shard i - 1's down halo
        return dgs
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


class _RdmaHalo(torch.autograd.Function):
    """exchange_row_halo_rdma under autograd: the forward through the
    kernels, the backward _rdma_halo_vjp (the kernels again)."""

    @staticmethod
    def forward(ctx, band, fill, *blocks):
        ctx.band, ctx.h = band, blocks[0].shape[-2]
        ups, downs = exchange_row_halo_rdma_parts(blocks, band, fill)
        return tuple(torch.cat([u, g, d], dim=-2) for u, g, d in zip(ups, blocks, downs))

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, *_rdma_halo_vjp(cts, ctx.band, ctx.h))


def exchange_row_halo_rdma(blocks: Sequence[torch.Tensor], band: int, fill) -> List[torch.Tensor]:
    """Drop-in for halo.exchange_row_halo through the kernels: each shard's
    (..., H_local, W) block with ``band`` halo rows above and below,
    differentiable with respect to the blocks."""
    blocks = [g.contiguous() for g in blocks]
    if torch.is_grad_enabled() and any(g.requires_grad for g in blocks):
        return list(_RdmaHalo.apply(int(band), fill, *blocks))
    ups, downs = exchange_row_halo_rdma_parts(blocks, band, fill)
    return [torch.cat([u, g, d], dim=-2) for u, g, d in zip(ups, blocks, downs)]
