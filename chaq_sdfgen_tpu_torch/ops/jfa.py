"""Jump-flood (JFA) nearest-seed propagation, plain PyTorch
(chaq_sdfgen_tpu/ops/jfa.py). The JAX package has no Pallas kernel here, so
these torch ops are the implementation on every device, the card included.

State per pixel: one packed int32, (sy << xbits) | sx, -1 where no seed is
known. Each stride k pulls the 8 neighbours at offsets in (-k, 0, k)^2 and
keeps the closest. The schedule is the JAX package's, so that (sy, sx, d2,
valid) are bitwise equal to it: synchronous strides (every candidate reads
the state as of the stride's start), strides halving from the largest
power of two below max(H, W) with an optional stride-1 prepass ("1+JFA"),
neighbours dy outer and dx inner, and a strict ``<`` take (the first of
equal candidates wins). torch's ``>>`` on int32 is arithmetic, as XLA's is,
so -1 unpacks to -1. All arithmetic is int32; distances convert to float
only at the end, through the correctly rounded refined_sqrt.
"""

from __future__ import annotations

import torch

from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt

INVALID_D2 = 1 << 30  # sqrt reads 32768.0, far above any byte clamp


def _shift2d(arr: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """out[..., y, x] = arr[..., y + dy, x + dx], ``fill`` outside."""
    h, w = arr.shape[-2:]
    out = torch.full_like(arr, fill)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[..., yd, xd] = arr[..., ys, xs]
    return out


def strides(h: int, w: int, plus_one: bool) -> list:
    """The stride schedule: the largest power of two below max(H, W), halving
    to 1, after a stride-1 prepass when ``plus_one``."""
    n = max(h, w)
    k = 1
    while k < n:
        k <<= 1
    k >>= 1
    out = [1] if (plus_one and n > 1) else []
    while k >= 1:
        out.append(k)
        k >>= 1
    return out or [1]


def jfa_seed_coords(seeds: torch.Tensor, plus_one: bool = True):
    """seeds: (..., H, W) bool. Returns (sy, sx, d2, valid): the coordinates
    of each pixel's nearest found seed (int32, 0 where none), the squared
    distance to it (int32, INVALID_D2 where none) and the validity mask."""
    h, w = seeds.shape[-2:]
    dev = seeds.device
    yy = torch.arange(h, dtype=torch.int32, device=dev).view(h, 1)
    xx = torch.arange(w, dtype=torch.int32, device=dev).view(1, w)
    xbits = max((w - 1).bit_length(), 1)
    mask = (1 << xbits) - 1
    invalid = torch.full((), INVALID_D2, dtype=torch.int32, device=dev)
    none = torch.full((), -1, dtype=torch.int32, device=dev)

    def dist2(p):
        dy, dx = yy - (p >> xbits), xx - (p & mask)
        return torch.where(p >= 0, dy * dy + dx * dx, invalid)

    p = torch.where(seeds, (yy << xbits) | xx, none)
    d2 = torch.where(seeds, torch.zeros_like(invalid), invalid)
    for k in strides(h, w, plus_one):
        sp = p  # synchronous: every candidate reads the stride's start
        # d2 == dist2(p) is an invariant; rebuilt from the packed state as JAX does
        d2 = dist2(sp)
        for dy in (-k, 0, k):
            for dx in (-k, 0, k):
                if dy == 0 and dx == 0:
                    continue
                cp = _shift2d(sp, dy, dx, -1)
                cd2 = dist2(cp)
                p = torch.where(cd2 < d2, cp, p)
                d2 = torch.minimum(d2, cd2)
    valid = p >= 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    sy = torch.where(valid, p >> xbits, zero)
    sx = torch.where(valid, p & mask, zero)
    return sy, sx, d2, valid


def jfa_distance(seeds: torch.Tensor, plus_one: bool = True) -> torch.Tensor:
    """Full-range distance to the nearest seed (float32) by jump flooding.
    Pixels with no reachable seed read sqrt(2^30) = 32768.0."""
    _, _, d2, _ = jfa_seed_coords(seeds, plus_one=plus_one)
    return refined_sqrt(d2.to(torch.float32))
