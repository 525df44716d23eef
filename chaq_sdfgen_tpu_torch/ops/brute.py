"""OpenCL-binary parity ("brute" mode), plain PyTorch
(chaq_sdfgen_tpu/ops/brute.py): the plain version of both BRUTE kernels
(ops/cuda_brute.py), on any device, for any spread and any H >= 1.

The reference kernel (opencl/sdf.cl:79-191, search_triangle) probes, per
pixel, every in-image offset with dx^2 + dy^2 <= spread^2 EXCEPT exact
diagonals |dx| == |dy|, a quirk reproduced here for byte parity. Its early
exits only change which equal-distance candidate wins, never the distance,
so a minimum over the candidate set is value-equivalent. Factored per row:
the distances from each pixel to the nearest and second-nearest seed on
each side of its row (the second stands in where the nearest sits on the
diagonal), then one scan over dy. Integer arithmetic throughout; ``found``
is decided on the int32 d^2, before the sqrt of its float32 conversion.
"""

from __future__ import annotations

import torch

from chaq_sdfgen_tpu_torch.ops.merge import opencl_sign_and_remap
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt, walk_done

_NONE = -(1 << 30)


def _cummax(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    if reverse:
        return torch.cummax(x.flip(-1), dim=-1).values.flip(-1)
    return torch.cummax(x, dim=-1).values


def _shift_x(x: torch.Tensor, by: int, fill: int) -> torch.Tensor:
    """out[..., i] = x[..., i - by] (by = +-1), ``fill`` where that is outside."""
    pad = torch.full_like(x[..., :1], fill)
    if by > 0:
        return torch.cat([pad, x[..., :-1]], dim=-1)
    return torch.cat([x[..., 1:], pad], dim=-1)


def row_seed_distances(seeds: torch.Tensor, sentinel: int):
    """Per-pixel distances (int32) to the nearest (L1/R1) and second-nearest
    (L2/R2) seed at or left / at or right of it in the row (last axis),
    clipped at ``sentinel``; missing seeds read ``sentinel``.

    The gap between a seed and its previous seed rides in the low bits of a
    packed cummax carry (pos * G + min(gap, sent), G a power of two >
    sent), so the scan that finds the nearest seed also delivers that
    seed's gap to ITS neighbour: L2 = L1 + carried gap."""
    w = seeds.shape[-1]
    idx = torch.arange(w, dtype=torch.int32, device=seeds.device).expand(seeds.shape)
    none = torch.full((), _NONE, dtype=torch.int32, device=seeds.device)
    sent = int(sentinel)
    gbits = max(sent.bit_length(), 1)
    g, gmask = 1 << gbits, (1 << gbits) - 1

    fwd = _cummax(torch.where(seeds, idx, none))
    l1 = torch.clamp(idx - fwd, max=sent)
    gap_l = torch.clamp(idx - _shift_x(fwd, 1, _NONE), max=sent)  # p - (seed at or before p-1)
    carried_l = _cummax(torch.where(seeds, idx * g + gap_l, none))
    l2 = torch.clamp(l1 + (carried_l & gmask), max=sent)
    l2 = torch.where(carried_l == none, sent, l2)

    # mirrored: the nearest seed at or after i carries its gap to the NEXT seed
    bwd = _cummax(torch.where(seeds, -idx, none), reverse=True)
    r1 = torch.clamp(-(idx + bwd), max=sent)
    gap_r = torch.clamp(-idx - _shift_x(bwd, -1, _NONE), max=sent)
    carried_r = _cummax(torch.where(seeds, (-idx) * g + gap_r, none), reverse=True)
    r2 = torch.clamp(r1 + (carried_r & gmask), max=sent)
    r2 = torch.where(carried_r == none, sent, r2)
    return l1, l2, r1, r2


def seed_strips(b: torch.Tensor, spread: int) -> torch.Tensor:
    """Pass A for both polarities: (..., H, W) bool mask or uint8 tri-state
    codes (threshold.as_codes) -> (2, 4, ..., H, W) int32, [polarity][L1,
    L2, R1, R2] with polarity 0 the TRUE pixels (code 1) as seeds and 1 the
    FALSE ones (code 0), clipped at spread + 1; code 2 seeds neither."""
    sent = spread + 1
    seeds = (b, torch.logical_not(b)) if b.dtype == torch.bool else (b == 1, b == 0)
    return torch.stack([torch.stack(row_seed_distances(s, sent)) for s in seeds])


def triangle_d2(b: torch.Tensor, strips: torch.Tensor, spread: int) -> torch.Tensor:
    """Per-pixel min squared distance (int32) to a pixel of the other value
    over the triangle candidate set (|dx| != |dy|); values > spread^2 mean
    not found. strips: seed_strips(b, spread) (any integer dtype). Rows
    outside the image read spread + 1 (more than spread: never found).

    The scan over |dy| stops once dy^2 reaches the largest running minimum
    (no later tap can lower any pixel), checked every few steps."""
    sent = spread + 1
    h = b.shape[-2]
    strips = strips.to(torch.int32)
    pad = strips.new_full(strips.shape[:-2] + (spread, strips.shape[-1]), sent)
    ext = torch.cat([pad, strips, pad], dim=-2)
    acc = torch.full(b.shape, 2 * sent * sent + 1, dtype=torch.int32, device=b.device)
    for a in range(spread + 1):
        if walk_done(a, acc):
            break
        for dy in ((0,) if a == 0 else (-a, a)):
            rows = ext[..., spread + dy : spread + dy + h, :]
            # the candidates of a pixel are the seeds of the other polarity (sdf.cl:201)
            l1, l2, r1, r2 = (torch.where(b, rows[1, k], rows[0, k]) for k in range(4))
            cl = torch.where(l1 == a, l2, l1)  # skip the exact diagonal (quirk)
            cr = torch.where(r1 == a, r2, r1)
            dx = torch.minimum(cl, cr)
            torch.minimum(acc, dx * dx + a * a, out=acc)
    return acc


def brute_tail(d2: torch.Tensor, b: torch.Tensor, spread: int, asymmetric: bool,
               invert: bool) -> torch.Tensor:
    """found = d2 <= spread^2, the correctly rounded sqrt, then the OpenCL
    sign rule, +-INF fallback and clamped remap -> uint8."""
    found = d2 <= spread * spread
    d = refined_sqrt(d2.to(torch.float32))
    return opencl_sign_and_remap(d, found, b, spread, asymmetric, invert, big=float(2 * spread + 4))
