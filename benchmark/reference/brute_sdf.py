"""Plain reference of the ``brute_s64`` configuration: the OpenCL binary's
output bytes (opencl/sdf.cl:193-224, kernel ``sdf`` and its
``search_triangle``), in plain PyTorch on any device. Independent of the
program: it imports nothing of it, and it finds distances its own way.

  threshold   b = image[..., channel] > 127, always (sdf.cl:2-7); the
              binary's ``invert`` flips the sign decider, not the test
  candidates  the pixels of the other value at an offset (dx, dy) with
              0 < dx^2 + dy^2 <= spread^2 and |dx| != |dy|: the triangle
              search never probes an exact diagonal
  d2          per row offset dy (|dy| <= reach, default spread): along the
              row at y + dy, the nearest and second-nearest candidate on
              each side of the pixel's column (running maxima of seed
              indices, the second read back through the first), the second
              standing in where the nearest lies on the diagonal
              |dx| == |dy|; the least dx^2 + dy^2 over every dy
  found       d2 <= spread^2, on the integer d2
  bytes       decider = invert ^ value; found: decider ? d : -(d - 1),
              d = sqrt(d2); else decider ? +INF : -INF; clamped to
              [s_min, spread], then ((v - s_min) * 255) / (spread - s_min)
              truncated to uint8

The last step runs as a table over d2 made in NumPy's float32 in the
kernel's operation order, so the bytes are those of float arithmetic; with
``precision`` "bfloat16" the table is made in bfloat16: the control, one
precision below the configuration's. ``reach`` below spread cuts the
column search short: a planted fault.

Departures from sdf.cl, none of which changes a byte:
- the binary searches rings outward and stops at the first hit; a minimum
  over the same candidate set gives the same distance, whichever of two
  candidates at one distance the binary would have returned;
- offsets outside the image are skipped (sdf.cl:110-111 reads one pixel
  past the edge, which is undefined; sdfref's oracle skips it too);
- the square root and the division are IEEE float32, correctly rounded;
  +-INF is a table entry that clamps to the bytes INF gives.
"""

from __future__ import annotations

import numpy as np
import torch


def _nearest_two_left(seed: torch.Tensor, cap: int):
    """(..., H, W) bool -> (first, second): int32 distance along each row to
    the nearest seed at or left of each pixel and to the seed before that
    one, each capped at ``cap`` (also where the row has none)."""
    w = seed.shape[-1]
    idx = torch.arange(w, device=seed.device, dtype=torch.int32).expand_as(seed)
    far = torch.full_like(idx, -2 * (w + cap))
    p1 = torch.where(seed, idx, far).cummax(-1).values
    # the nearest seed at or left of x - 1, read at x = p1: the seed before p1
    before = torch.cat([far[..., :1], p1[..., :-1]], -1)
    p2 = torch.where(p1 >= 0, before.gather(-1, p1.clamp(min=0).long()), far)
    return (idx - p1).clamp(max=cap), (idx - p2).clamp(max=cap)


def row_strips(seed: torch.Tensor, cap: int) -> torch.Tensor:
    """(..., H, W) bool -> (4, ..., H, W) int32: [left 1, left 2, right 1,
    right 2], the distances to the nearest and second-nearest seed on each
    side of a pixel's column (the column itself counting on both sides),
    capped at ``cap``."""
    l1, l2 = _nearest_two_left(seed, cap)
    r1, r2 = _nearest_two_left(seed.flip(-1), cap)
    return torch.stack([l1, l2, r1.flip(-1), r2.flip(-1)])


def triangle_d2(b: torch.Tensor, spread: int, reach: int) -> torch.Tensor:
    """(H, W) bool -> int32 least dx^2 + dy^2 to a pixel of the other value
    over |dx| != |dy| and |dy| <= ``reach``, clipped to spread^2 + 1 (not
    found)."""
    cap = spread + 1  # farther than spread along the row: never found
    h = b.shape[-2]
    # strips[p]: the seeds of polarity p (0: TRUE pixels, 1: FALSE pixels),
    # rows outside the image padded with cap
    pad = torch.full((2, 4, reach, b.shape[-1]), cap, dtype=torch.int32, device=b.device)
    strips = torch.cat([pad, torch.stack([row_strips(b, cap), row_strips(~b, cap)]), pad], -2)
    best = torch.full(b.shape, spread * spread + 1, dtype=torch.int32, device=b.device)
    for dy in range(-reach, reach + 1):
        a = abs(dy)
        rows = strips[..., reach + dy : reach + dy + h, :]
        # a TRUE pixel's candidates are FALSE pixels (polarity 1), and back
        l1, l2, r1, r2 = (torch.where(b, rows[1, k], rows[0, k]) for k in range(4))
        dx = torch.minimum(torch.where(l1 == a, l2, l1), torch.where(r1 == a, r2, r1))
        torch.minimum(best, dx * dx + a * a, out=best)
    return best.clamp(max=spread * spread + 1)


def byte_tables(spread: int, asymmetric: bool, precision: str = "float32"):
    """(on_decider, off_decider): uint8 tables over d2 = 0 .. spread^2 + 1
    of the byte of a pixel whose decider is true (+d) and false (-(d - 1));
    the last entry stands for "not found" (+INF and -INF)."""
    if precision == "float32":
        def cast(a):
            return np.asarray(a, np.float32)
        sqrt, minimum, maximum, where = np.sqrt, np.minimum, np.maximum, np.where
        to_numpy = np.asarray
    elif precision == "bfloat16":
        def cast(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
        sqrt, minimum, maximum = torch.sqrt, torch.minimum, torch.maximum

        def where(mask, a, b):
            return torch.where(torch.from_numpy(mask), a, b)

        def to_numpy(t):
            return t.to(torch.float32).numpy()
    else:
        raise ValueError(f"unknown precision {precision!r}")
    d2 = np.arange(spread * spread + 2)
    d = sqrt(cast(d2))
    missing = d2 == d2[-1]
    s_min, s_max = cast(0.0 if asymmetric else -float(spread)), cast(float(spread))

    def remap(v):
        v = maximum(minimum(v, s_max), s_min)
        return to_numpy(((v - s_min) * cast(255.0)) / (s_max - s_min) + cast(0.0)).astype(np.uint8)

    return (remap(where(missing, cast(np.inf), d)),
            remap(where(missing, cast(-np.inf), -(d + cast(-1.0)))))


def sdf_bytes(images: torch.Tensor, sdf_config: dict, precision: str = "float32", reach: int = None) -> torch.Tensor:
    """(..., H, W, 2) uint8 -> (..., H, W) uint8 on the images' device: the
    OpenCL binary's bytes (``precision`` "bfloat16": the control's;
    ``reach`` below spread cuts the column search short, a planted
    fault)."""
    spread = int(sdf_config["spread"])
    channel = 0 if sdf_config["channel"] == "luminance" else 1
    b = images[..., channel] > 127
    reach = spread if reach is None else int(reach)
    on, off = (torch.from_numpy(t).to(images.device)
               for t in byte_tables(spread, bool(sdf_config["asymmetric"]), precision))
    out = torch.empty(b.shape, dtype=torch.uint8, device=images.device)
    flat_b, flat_out = b.reshape(-1, *b.shape[-2:]), out.view(-1, *b.shape[-2:])
    for i in range(flat_b.shape[0]):  # an image at a time, to bound memory
        bi = flat_b[i]
        d2 = triangle_d2(bi, spread, reach).long()
        decider = bi ^ bool(sdf_config["invert"])
        flat_out[i] = torch.where(decider, on[d2], off[d2])
    return out
