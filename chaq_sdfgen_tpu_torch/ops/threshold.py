"""Threshold / indicator ops (chaq_sdfgen_tpu/ops/threshold.py, hard part).

Hard path mirrors transform_img_to_bool (openmp/sdfgen.c:52-62). The soft
functions wait for the soft path (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

THRESHOLD = 127  # the fixed byte threshold (openmp/sdfgen.c:57)


def hard_threshold(img2ch: torch.Tensor, channel: int = 1, test_above: bool = True) -> torch.Tensor:
    """(..., H, W, 2) uint8 -> (..., H, W) bool: chan > 127 (or < when
    inverted; the OpenMP -n flag flips the test itself, sdfgen.c:58-59)."""
    chan = img2ch[..., channel]
    return (chan > THRESHOLD) if test_above else (chan < THRESHOLD)


def indicator(b: torch.Tensor, true_is_zero: bool, big: float) -> torch.Tensor:
    """bool -> {0, big} float32 parabola heights (transform_bool_to_float,
    openmp/sdfgen.c:65-72); ``big`` is the finite stand-in for +inf."""
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    bigv = torch.full((), big, dtype=torch.float32, device=b.device)
    return torch.where(b == true_is_zero, zero, bigv)
