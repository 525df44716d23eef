"""The yardstick's arithmetic: the peaks of the card and the least work a
transform needs, whatever kernels implement it (frozen copies of
chip_smoke.py's ``bound`` and ``band_bytes_flops``; nothing of the program is
read). A share of a roofline is the least time this work could take on the
card, the larger of its bytes at the memory rate and its operations at the
float32 rate, over the device time the work took."""

from __future__ import annotations

# One NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet, dense rates): the
# memory rate and float32 outside the tensor cores. Each run logs the card's
# power limit beside its readings.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def floor_seconds(nbytes: float, flops: float) -> tuple:
    """(seconds, bound): the larger of ``nbytes`` at the memory rate and
    ``flops`` at the float32 rate, and which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def band_bytes_flops(npix: int) -> float:
    """Float operations the EXACT transform's pass 2 needs a pixel, whatever
    the algorithm: per field ~15 for a linear-time lower envelope of the
    clipped column parabolas (an intersection and an evaluation), plus ~25
    for the square root, merge and remap of the pixel."""
    return (2 * 15 + 25) * npix


def hard_floor(npix: int) -> tuple:
    """The EXACT transform of ``npix`` gray+alpha uint8 pixels: each input
    byte read once (2) and each output byte written once (1), and pass 2's
    operations."""
    return floor_seconds(3 * npix, band_bytes_flops(npix))


def soft_step_floor(npix: int) -> tuple:
    """A soft training step on ``npix`` pixels, by bytes alone: the float32
    two-channel input (8) and the float32 target (4), each read once. The
    field and the gradients are intermediates and the parameters scalars;
    an operation floor that holds for every soft-min algorithm is not
    known."""
    return floor_seconds(12 * npix, 0.0)


def share_pct(floor_s: float, device_s: float):
    """100 floor / device time, or None where no device time was read."""
    return 100.0 * floor_s / device_s if device_s > 0 else None
