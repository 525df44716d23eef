"""Signed merge + byte remap (chaq_sdfgen_tpu/ops/merge.py).

Float32 operation order mirrors the C code exactly so the output bytes are
bit-identical: signed_merge <- transform_float_sub (openmp/sdfgen.c:98-106),
remap_to_byte <- transform_float_to_byte (openmp/sdfgen.c:75-96), and the
OpenCL variant opencl_sign_and_remap <- linear_remap + the sign rule
(opencl/sdf.cl:17-23, 206-219). soft_remap is the soft path's
differentiable remap.
"""

from __future__ import annotations

import torch

from chaq_sdfgen_tpu_torch.ops.numerics import div


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


def opencl_sign_and_remap(
    d: torch.Tensor,
    found: torch.Tensor,
    this_val: torch.Tensor,
    spread: int,
    asymmetric: bool,
    invert: bool,
    big: float,
) -> torch.Tensor:
    """OpenCL kernel tail (opencl/sdf.cl:206-223): decider = invert ^ val;
    dist = found ? (decider ? +d : -(d-1)) : +-INF; clamped remap with an
    IEEE division and a truncating u8 cast. ``big`` substitutes INFINITY
    (it clamps identically)."""
    decider = torch.logical_xor(this_val, torch.tensor(bool(invert), device=this_val.device))
    signed = torch.where(decider, d, -(d + (-1.0)))
    bigv = torch.full((), big, dtype=torch.float32, device=d.device)
    dist = torch.where(found, signed, torch.where(decider, bigv, -bigv))
    src_min = 0.0 if asymmetric else -float(spread)
    v = torch.clamp(torch.clamp(dist, max=float(spread)), min=src_min)
    remap = div((v - src_min) * 255.0, float(spread) - src_min) + 0.0
    # values are in [0, 255]: the int32 step truncates toward zero like C
    return remap.to(torch.int32).to(torch.uint8)


def soft_remap(vals: torch.Tensor, spread: int, asymmetric: bool, clamp: str = "tanh") -> torch.Tensor:
    """Differentiable remap to [0, 255] float32. clamp: 'hard' (min/max,
    zero gradient outside the range), 'tanh' (smooth saturation), 'none'.
    Divides by 0-d tensors on the input's device (IEEE on CUDA too)."""
    if clamp not in ("hard", "tanh", "none"):
        raise ValueError(f"unknown clamp {clamp!r}")
    s_min = 0.0 if asymmetric else -float(spread)
    s_max = float(spread)
    sn = s_max - s_min  # exact: both are small integers
    if clamp == "hard":
        v = torch.clamp(vals, s_min, s_max)
    elif clamp == "tanh":
        mid = (s_max + s_min) * 0.5
        half = sn * 0.5
        v = mid + half * torch.tanh(div(vals - mid, half))
    else:
        v = vals
    return div((v - s_min) * 255.0, sn)
