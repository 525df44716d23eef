"""Plain reference of the ``exact_s64`` configuration: the OpenMP binary's
output bytes (openmp/sdfgen.c: threshold, the exact EDT of both
polarities, the -1 inside bias, the clamped remap with a truncating cast),
in plain PyTorch on any device. Independent of the program: it imports
nothing of it, and it finds distances its own way.

  threshold   b = image[..., channel] > 127 (or < 127 inverted)
  distances   d2 to the nearest pixel of each polarity: the nearest seed
              along the row from running maxima of seed indices, then the
              least dy^2 + row^2 over the column within |dy| <= R
  bytes       on a TRUE pixel sqrt(d2 to FALSE), on a FALSE one
              1 - sqrt(d2 to TRUE); clamped to [s_min, spread], then
              ((v - s_min) * 255) / (spread - s_min) truncated to uint8

R = spread + 2: a pixel within R of a seed finds its nearest seed (the
seed's |dy| is at most its distance), and one farther gets a d2 above R^2
or none, which clamps to the same byte as its true distance (the byte
saturates beyond spread + 1). The last step runs as a table over d2 made in
NumPy's float32 in the binary's operation order, so the bytes are those of
the binary's float32 arithmetic; ``precision`` "bfloat16" makes that table
in bfloat16 instead: the control, one precision below the configuration's.
"""

from __future__ import annotations

import numpy as np
import torch


def _row_distance(seed: torch.Tensor, cap: int) -> torch.Tensor:
    """(..., H, W) bool -> int32 distance along each row to the nearest
    seed, capped at ``cap`` (also where the row has none)."""
    w = seed.shape[-1]
    idx = torch.arange(w, device=seed.device, dtype=torch.int32).expand_as(seed)
    far = torch.full_like(idx, -2 * (w + cap))
    left = torch.where(seed, idx, far).cummax(-1).values
    right = torch.where(seed.flip(-1), idx, far).cummax(-1).values.flip(-1)
    right = (w - 1) - right  # the nearest seed at or after x, from the flipped running max
    d = torch.minimum(idx - left, right - idx)
    return d.clamp(max=cap)


def nearest_d2(seed: torch.Tensor, reach: int) -> torch.Tensor:
    """(..., H, W) bool -> int32 squared distance to the nearest seed, exact
    up to reach^2; (reach + 1)^2 where no seed lies within ``reach``."""
    far = (reach + 1) ** 2
    row = _row_distance(seed, reach + 1)
    g = (row * row).clamp(max=far)
    h = g.shape[-2]
    pad = torch.full(g.shape[:-2] + (reach,) + g.shape[-1:], far, dtype=g.dtype, device=g.device)
    gp = torch.cat([pad, g, pad], -2)
    best = torch.full_like(g, far)
    for dy in range(-reach, reach + 1):
        best = torch.minimum(best, gp.narrow(-2, reach + dy, h) + dy * dy)
    return best.clamp(max=far)


def byte_tables(spread: int, asymmetric: bool, reach: int, precision: str = "float32"):
    """(on_true, on_false): uint8 tables over d2 = 0 .. (reach + 1)^2 of
    the byte of a TRUE pixel at d2 from FALSE and of a FALSE pixel at d2
    from TRUE; the last entry stands for "farther than reach"."""
    d2 = np.arange((reach + 1) ** 2 + 1)
    if precision == "float32":
        f, cast = np.float32, lambda a: a.astype(np.float32)
        d = np.sqrt(d2.astype(np.float32), dtype=np.float32)
    elif precision == "bfloat16":
        f = None
        cast = lambda a: torch.as_tensor(a).to(torch.bfloat16)
        d = torch.sqrt(torch.as_tensor(d2, dtype=torch.float32).to(torch.bfloat16))
    else:
        raise ValueError(f"unknown precision {precision!r}")
    inf = float("inf")
    s_min = 0.0 if asymmetric else -float(spread)
    s_max = float(spread)

    def remap(v):
        if f is not None:
            v = np.maximum(np.minimum(v, f(s_max)), f(s_min))
            out = ((v - f(s_min)) * f(255.0)) / (f(s_max) - f(s_min)) + f(0.0)
            return out.astype(np.uint8)
        lo, hi = cast(np.float32(s_min)), cast(np.float32(s_max))
        v = torch.maximum(torch.minimum(v, hi), lo)
        out = ((v - lo) * cast(np.float32(255.0))) / (hi - lo) + cast(np.float32(0.0))
        return out.to(torch.float32).numpy().astype(np.uint8)

    if f is not None:
        true_v = d.copy()
        true_v[-1] = inf
        false_v = -(d + f(-1.0))
        false_v[-1] = -inf
    else:
        true_v = d.clone()
        true_v[-1] = inf
        false_v = -(d + cast(np.float32(-1.0)))
        false_v[-1] = -inf
    return remap(true_v), remap(false_v)


def sdf_bytes(images: torch.Tensor, sdf_config: dict, precision: str = "float32", reach: int = None) -> torch.Tensor:
    """(..., H, W, 2) uint8 -> (..., H, W) uint8 on the images' device: the
    binary's bytes (``precision`` "bfloat16": the control's; ``reach`` below
    spread + 2 cuts the column search short, a planted fault)."""
    spread = int(sdf_config["spread"])
    asymmetric = bool(sdf_config["asymmetric"])
    channel = 0 if sdf_config["channel"] == "luminance" else 1
    chan = images[..., channel]
    b = chan < 127 if sdf_config["invert"] else chan > 127
    reach = spread + 2 if reach is None else int(reach)
    on_true, on_false = (torch.from_numpy(t).to(images.device)
                         for t in byte_tables(spread, asymmetric, reach, precision))
    out = torch.empty(b.shape, dtype=torch.uint8, device=images.device)
    flat_b, flat_out = b.reshape(-1, *b.shape[-2:]), out.view(-1, *b.shape[-2:])
    for i in range(flat_b.shape[0]):  # an image at a time, to bound memory
        bi = flat_b[i]
        to_false = nearest_d2(~bi, reach).long()
        to_true = nearest_d2(bi, reach).long()
        flat_out[i] = torch.where(bi, on_true[to_false], on_false[to_true])
    return out
