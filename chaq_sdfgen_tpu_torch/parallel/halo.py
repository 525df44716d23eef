"""Halo exchange between the shards of a chain (chaq_sdfgen_tpu/parallel/
halo.py), on lists of per-shard blocks in mesh order along one axis.

This is the ``ppermute`` implementation: each receiving shard gathers the
rows it needs from the blocks that hold them with ``Tensor.to`` (a peer
copy by the CUDA runtime between cards; no copy between logical shards of
one device) and the edge ``fill`` where the rows lie beyond the image.
The halo of a shard reaches as many neighbours as it spans (multi-hop
where the band exceeds a shard's height), each contributing only the rows
inside the halo. The values are JAX's, whatever the schedule; this is
also the plain version that the ``rdma`` kernels (parallel/cuda_halo.py)
are held against. The exchange is made of slices, ``Tensor.to`` and
``torch.cat``, so torch autograd gives its VJP: each halo row's cotangent
is added back to the shard that owns the row, multi-hop included, and the
fill takes none. exchange_row_halo and exchange_row_halo_many with a few
edge rows are also the counterpart of pallas_soft_mm._edge_exchange (the
declared kernels' gray halo and their backward's edge rows of the
cotangent and the memos).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _global_rows(blocks: Sequence[torch.Tensor], i: int, start: int, count: int, dim: int,
                 fill) -> torch.Tensor:
    """Global rows [start, start + count) along ``dim`` of the chain, on
    block i's device: slices of the blocks that hold them, ``fill`` beyond
    the first and last block."""
    g = blocks[i]
    h = g.shape[dim]
    end, total = start + count, len(blocks) * h
    parts, y = [], start
    while y < end:
        if y < 0 or y >= total:
            nxt = min(end, 0) if y < 0 else end
            shape = list(g.shape)
            shape[dim] = nxt - y
            parts.append(torch.full(shape, fill, dtype=g.dtype, device=g.device))
        else:
            s = y // h
            nxt = min(end, (s + 1) * h)
            parts.append(blocks[s].narrow(dim, y - s * h, nxt - y).to(g.device))
        y = nxt
    if not parts:
        return g.narrow(dim, 0, 0)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def exchange_row_halo_parts(blocks: Sequence[torch.Tensor], band: int, fill,
                            dim: int = -2) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(from_up, from_down): for each shard of the chain, the ``band`` rows
    above it and the ``band`` rows below it, each (..., band, W), ``fill``
    beyond the image. blocks: (..., H_local, W), one per shard."""
    h = blocks[0].shape[dim]
    ups = [_global_rows(blocks, i, i * h - band, band, dim, fill) for i in range(len(blocks))]
    downs = [_global_rows(blocks, i, (i + 1) * h, band, dim, fill) for i in range(len(blocks))]
    return ups, downs


def exchange_row_halo(blocks: Sequence[torch.Tensor], band: int, fill) -> List[torch.Tensor]:
    """Each shard's block with its halos attached: (..., H_local + 2 band, W)."""
    ups, downs = exchange_row_halo_parts(blocks, band, fill)
    return [torch.cat([u, g, d], dim=-2) for u, g, d in zip(ups, blocks, downs)]


def exchange_row_halo_many(arrays: Sequence[Sequence[torch.Tensor]], band: int, fills: Sequence) -> List[List[torch.Tensor]]:
    """exchange_row_halo of several chains, each with its fill."""
    return [exchange_row_halo(blocks, band, fill) for blocks, fill in zip(arrays, fills)]


def exchange_col_halo(blocks: Sequence[torch.Tensor], band: int, fill) -> List[torch.Tensor]:
    """Column twin for a chain along the 'x' axis of a 2-D tile mesh:
    (..., H, W_local) -> (..., H, W_local + 2 band)."""
    lefts, rights = exchange_row_halo_parts(blocks, band, fill, dim=-1)
    return [torch.cat([l, g, r], dim=-1) for l, g, r in zip(lefts, blocks, rights)]


def fetch_row_slab(blocks: Sequence[torch.Tensor], offset: int, fill, dim: int = -2) -> List[torch.Tensor]:
    """Same-shape slabs shifted ``offset`` rows in global coordinates: row y
    of shard i's slab holds global row (y_global - offset), ``fill`` beyond
    the image; offset may be any stride of either sign (JFA's taps). A slab
    reads at most H_local rows, from the at most two shards it straddles.
    Any dtype: rows beyond the image are written as ``fill``, where JAX
    ships (g - fill) and adds fill back (exact for its integer states)."""
    h = blocks[0].shape[dim]
    return [_global_rows(blocks, i, i * h - offset, h, dim, fill) for i in range(len(blocks))]


def fetch_col_slab(blocks: Sequence[torch.Tensor], offset: int, fill) -> List[torch.Tensor]:
    """Column twin of fetch_row_slab: column x of shard i's slab holds
    global column (x_global - offset)."""
    return fetch_row_slab(blocks, offset, fill, dim=-1)
