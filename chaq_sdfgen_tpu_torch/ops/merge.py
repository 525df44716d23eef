"""Signed merge + byte remap (chaq_sdfgen_tpu/ops/merge.py, hard part).

Float32 operation order mirrors the C code exactly so the output bytes are
bit-identical: signed_merge <- transform_float_sub (openmp/sdfgen.c:98-106),
remap_to_byte <- transform_float_to_byte (openmp/sdfgen.c:75-96). The OpenCL
sign rule and the soft functions wait for BRUTE and the soft path.
"""

from __future__ import annotations

import torch


def signed_merge(outside: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """outside - (inside > 0 ? inside - 1 : inside). The -1 bias puts the
    zero level on boundary pixels (openmp/sdfgen.c:102-104)."""
    biased = torch.where(inside > 0, inside + (-1.0), inside)
    return outside - biased


def remap_to_byte(vals: torch.Tensor, spread: int, asymmetric: bool) -> torch.Tensor:
    """Clamped linear remap [s_min, spread] -> [0, 255] with a truncating u8
    cast, in the reference's exact f32 op order (openmp/sdfgen.c:81-94)."""
    f32 = dict(dtype=torch.float32, device=vals.device)
    s_min = torch.tensor(0.0 if asymmetric else -float(spread), **f32)
    s_max = torch.tensor(float(spread), **f32)
    sn = s_max - s_min
    v = torch.minimum(vals, s_max)
    v = torch.maximum(v, s_min)
    remap = ((v - s_min) * 255.0) / sn + 0.0
    # values are in [0, 255]: the int32 step truncates toward zero like C
    return remap.to(torch.int32).to(torch.uint8)
