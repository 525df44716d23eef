"""The one generator of the benchmark's traffic: it reads a mix's data file
(benchmark/traffic/<name>.json) and makes its inputs on the device from the
seed, in a few large calls. A PyTorch rewrite of chip_smoke.py's NumPy
``glyph_image`` and ``noise_image`` (a frozen copy: nothing of the program or
of chip_smoke.py is imported).

A mix's file gives, per channel of the (..., H, W, 2) gray+alpha input, a
layer:
  {"layer": "uniform", "low": a, "high": b}     integers in [a, b]
  {"layer": "strokes", "cell": c, "empty_share": e, "strokes": [n0, n1],
   "margin": m, "radius": [r0, r1], "on": v1, "off": v0}
      the glyph atlas: the page cut into c x c cells, a share e of them
      empty, n0..n1 capsules in each other, their end points uniform in
      [m, c - m) and their radius uniform in [r0, r1); inside: v1
then ``values``: {"dtype": "uint8"} or {"dtype": "float32", "offset": o,
"scale": s}, the float input being (v + o) * s; optionally ``target``, a
float32 (..., H, W) per input: {"layer": "uniform_float", "low": a, "high":
b}; ``pool``: how many distinct inputs a run cycles through.

Each input of the pool comes from its own generator, seeded from (seed,
stream, index): the same seed gives the same inputs, on one kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

CHANNELS = ("gray", "alpha")
INPUTS, TARGETS = 0, 1  # streams


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for the stream ``keys`` of run ``seed`` (any whole
    number; a negative one is taken modulo 2**64)."""
    words = np.random.SeedSequence([int(seed) % 2**64, *map(int, keys)]).generate_state(2, dtype=np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(device, seed: int, *keys: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *keys))
    return g


def _uniform(g, shape, p, device) -> torch.Tensor:
    return torch.randint(int(p["low"]), int(p["high"]) + 1, shape, generator=g, device=device,
                         dtype=torch.int32).to(torch.uint8)


def _strokes(g, shape, p, device) -> torch.Tensor:
    """(n, H, W) uint8: capsules in the cells of each page, on a grid of
    float32 pixel centres (chip_smoke.glyph_image's rasterisation)."""
    n, h, w = shape
    cell = int(p["cell"])
    if h % cell or w % cell:
        raise ValueError(f"strokes: a {h}x{w} page does not split into {cell}-pixel cells")
    cells = (n, h // cell, w // cell)
    lo, hi = (int(v) for v in p["strokes"])
    margin = float(p["margin"])
    r0, r1 = (float(v) for v in p["radius"])
    f32 = dict(device=device, dtype=torch.float32)
    keep = torch.rand(cells, generator=g, **f32) >= float(p["empty_share"])
    count = torch.randint(lo, hi + 1, cells, generator=g, device=device)
    ends = margin + torch.rand(cells + (hi, 2, 2), generator=g, **f32) * (cell - 2 * margin)
    radius = r0 + torch.rand(cells + (hi,), generator=g, **f32) * (r1 - r0)
    yy = torch.arange(cell, **f32).view(cell, 1)
    xx = torch.arange(cell, **f32).view(1, cell)
    mask = torch.zeros(cells + (cell, cell), dtype=torch.bool, device=device)
    for j in range(hi):
        a, b = ends[..., j, 0, :], ends[..., j, 1, :]
        d = b - a
        dd = (d * d).sum(-1).clamp(min=1e-6)[..., None, None]
        ay, ax = a[..., 0, None, None], a[..., 1, None, None]
        dy, dx = d[..., 0, None, None], d[..., 1, None, None]
        t = (((yy - ay) * dy + (xx - ax) * dx) / dd).clamp(0.0, 1.0)
        dist2 = (yy - ay - t * dy) ** 2 + (xx - ax - t * dx) ** 2
        live = (keep & (count > j))[..., None, None]
        mask |= live & (dist2 <= (radius[..., j] ** 2)[..., None, None])
    page = mask.permute(0, 1, 3, 2, 4).reshape(n, h, w)
    on = torch.tensor(int(p["on"]), dtype=torch.uint8, device=device)
    off = torch.tensor(int(p["off"]), dtype=torch.uint8, device=device)
    return torch.where(page, on, off)


LAYERS = {"uniform": _uniform, "strokes": _strokes}


def make_input(mix: dict, size, batch: int, seed: int, index: int, device) -> torch.Tensor:
    """Input ``index`` of the pool: (batch, H, W, 2) in the mix's dtype."""
    h, w = (int(v) for v in size)
    g = generator(device, seed, INPUTS, index)
    planes = [LAYERS[mix["channels"][c]["layer"]](g, (batch, h, w), mix["channels"][c], device)
              for c in CHANNELS]
    x = torch.stack(planes, -1)
    values = mix["values"]
    if values["dtype"] == "uint8":
        return x
    if values["dtype"] != "float32":
        raise ValueError(f"unknown dtype {values['dtype']!r}")
    return (x.to(torch.float32) + float(values["offset"])) * float(values["scale"])


def make_target(mix: dict, size, batch: int, seed: int, index: int, device) -> torch.Tensor:
    """Target ``index`` of the pool: (batch, H, W) float32."""
    p = mix["target"]
    if p["layer"] != "uniform_float":
        raise ValueError(f"unknown target layer {p['layer']!r}")
    g = generator(device, seed, TARGETS, index)
    h, w = (int(v) for v in size)
    u = torch.rand((batch, h, w), generator=g, device=device, dtype=torch.float32)
    return float(p["low"]) + u * (float(p["high"]) - float(p["low"]))
