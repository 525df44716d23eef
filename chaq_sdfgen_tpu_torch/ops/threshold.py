"""Threshold / indicator ops (chaq_sdfgen_tpu/ops/threshold.py).

Hard path mirrors transform_img_to_bool (openmp/sdfgen.c:52-62); the soft
path replaces the step with a temperature-controlled sigmoid so gradients
flow to input intensities.
"""

from __future__ import annotations

import torch

from chaq_sdfgen_tpu_torch.ops.numerics import div, softplus
from chaq_sdfgen_tpu_torch.utils.profiling import recording, span

THRESHOLD = 127  # the fixed byte threshold (openmp/sdfgen.c:57)


def hard_threshold(img2ch: torch.Tensor, channel: int = 1, test_above: bool = True) -> torch.Tensor:
    """(..., H, W, 2) uint8 -> (..., H, W) bool: chan > 127 (or < when
    inverted; the OpenMP -n flag flips the test itself, sdfgen.c:58-59).
    Span ``sdf.threshold``."""
    if recording():
        with span("sdf.threshold"):
            return _hard_threshold(img2ch, channel, test_above)
    return _hard_threshold(img2ch, channel, test_above)


def _hard_threshold(img2ch: torch.Tensor, channel: int, test_above: bool) -> torch.Tensor:
    chan = img2ch[..., channel]
    return (chan > THRESHOLD) if test_above else (chan < THRESHOLD)


def as_mask(b: torch.Tensor) -> torch.Tensor:
    """Any mask -> bool (nonzero is TRUE), so that a 0/255 mask never
    reaches a row pass as codes (which seed TRUE at code 1 only)."""
    return b if b.dtype == torch.bool else b != 0


def as_codes(b: torch.Tensor) -> torch.Tensor:
    """The row passes' input: a bool mask -> {0, 1} uint8 codes (a view: a
    bool is stored as one byte, 0 or 1); uint8 tri-state codes (1 seeds
    TRUE, 0 seeds FALSE, 2 seeds neither: the image-edge columns of a 2-D
    tile's halo) pass through."""
    if b.dtype == torch.bool:
        return b.view(torch.uint8)
    if b.dtype != torch.uint8:
        raise TypeError(f"expected a bool mask or uint8 codes, got {b.dtype}")
    return b


def indicator(b: torch.Tensor, true_is_zero: bool, big: float) -> torch.Tensor:
    """bool -> {0, big} float32 parabola heights (transform_bool_to_float,
    openmp/sdfgen.c:65-72); ``big`` is the finite stand-in for +inf."""
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    bigv = torch.full((), big, dtype=torch.float32, device=b.device)
    return torch.where(b == true_is_zero, zero, bigv)


def soft_logits(gray: torch.Tensor, tau: float = 1.0, test_above: bool = True) -> torch.Tensor:
    """Threshold logits l = (v - 127.5)/tau (negated when inverted);
    occupancy = sigmoid(l). 127.5 is the midpoint of the hard test (v > 127
    <=> v >= 128 for integer bytes), so occupancy -> hard_threshold as
    tau -> 0."""
    logits = div(gray.to(torch.float32) - 127.5, tau)
    return logits if test_above else -logits


def soft_log_indicator_from_logits(
    logits: torch.Tensor, temperature: float, seeds_are_on: bool, big: float
) -> torch.Tensor:
    """Soft parabola heights h = -T log(o) (seeds on) or -T log(1 - o),
    computed stably from logits: -log(sigmoid(l)) = softplus(-l), exact
    where a sigmoid -> log round trip would underflow. Clipped at ``big``,
    the hard indicator's sentinel, recovering indicator() as tau -> 0."""
    l = logits if seeds_are_on else -logits
    h = softplus(-l) * temperature
    return torch.clamp(h, max=big)
