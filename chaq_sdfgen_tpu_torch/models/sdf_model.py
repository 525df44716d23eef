"""SDF generator pipelines (chaq_sdfgen_tpu/models/sdf_model.py, EXACT).

  hard_sdf_exact  -- OpenMP-binary semantics, byte-identical (Algorithm.EXACT)

BRUTE, JFA, the soft path and sharding are not ported yet (ROADMAP Queue 1
items 5-8 and 11); asking for them raises NotImplementedError.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.config import Algorithm, SdfConfig
from chaq_sdfgen_tpu_torch.ops import cuda_edt, threshold


def hard_sdf_exact(
    img2ch: torch.Tensor,
    spread: int,
    asymmetric: bool = False,
    channel: int = 1,
    test_above: bool = True,
    band: Optional[int] = None,
) -> torch.Tensor:
    """Full OpenMP-binary pipeline: (..., H, W, 2) uint8 -> (..., H, W)
    uint8 on the input's device. Threshold (-n via test_above), dual banded
    exact EDT, biased signed merge, clamped remap."""
    b = threshold.hard_threshold(img2ch, channel=channel, test_above=test_above)
    return hard_sdf_exact_from_bool(b, spread, asymmetric=asymmetric, band=band)


def hard_sdf_exact_from_bool(
    b: torch.Tensor,
    spread: int,
    asymmetric: bool = False,
    band: Optional[int] = None,
) -> torch.Tensor:
    """EXACT pipeline from a thresholded bool grid (..., H, W) -> uint8: the
    CUDA kernels for a CUDA tensor, their plain versions on the CPU."""
    return cuda_edt.fused_sdf_bytes(b, spread, asymmetric, band)


def default_device() -> torch.device:
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


class SDFGenerator:
    """Config-driven facade: construct once with an SdfConfig, call
    ``generate(image_2ch)`` for uint8 SDF bitmaps. PyTorch runs eagerly,
    so there is no compile cache to keep.

    device: where the pipeline runs (default: the first CUDA device when a
    card is present, else the CPU). Inputs are moved there; the result
    stays there."""

    def __init__(
        self,
        config: SdfConfig = SdfConfig(),
        soft=None,
        sharding=None,
        device: Union[str, torch.device, None] = None,
    ):
        if soft is not None:
            raise NotImplementedError("the soft path is not ported yet (ROADMAP Queue 1 item 5)")
        if sharding is not None:
            raise NotImplementedError(
                "multi-GPU sharding is not ported yet (ROADMAP Queue 1 item 11)"
            )
        if config.algorithm != Algorithm.EXACT:
            item = {Algorithm.BRUTE: 7, Algorithm.JFA: 8}[config.algorithm]
            raise NotImplementedError(
                f"Algorithm.{config.algorithm.name} is not ported yet (ROADMAP Queue 1 item {item})"
            )
        self.config = config
        self.device = torch.device(device) if device is not None else default_device()

    def _as_input(self, img2ch) -> torch.Tensor:
        if isinstance(img2ch, np.ndarray):
            img2ch = torch.from_numpy(np.ascontiguousarray(img2ch))
        if img2ch.dtype != torch.uint8 or img2ch.dim() < 3 or img2ch.shape[-1] != 2:
            raise ValueError(
                f"expected a (..., H, W, 2) uint8 image, got {img2ch.dtype} {tuple(img2ch.shape)}"
            )
        return img2ch.to(self.device)

    def generate(self, img2ch) -> torch.Tensor:
        """(..., H, W, 2) uint8 (numpy or torch) -> (..., H, W) uint8 on
        ``self.device``."""
        cfg = self.config
        return hard_sdf_exact(
            self._as_input(img2ch),
            spread=cfg.spread,
            asymmetric=cfg.asymmetric,
            channel=cfg.channel_offset,
            test_above=not cfg.invert,
            band=cfg.effective_band,
        )

    def kernel_time(self, img2ch, iters: int = 10) -> float:
        """Seconds per pipeline run on ``self.device``, the median of
        ``iters`` runs after one warm-up run (the counterpart of the
        reference's OpenCL event profiling, opencl/main.cpp:333-356). CUDA
        events time a CUDA device; the host clock times the CPU, where a
        run is synchronous."""
        x = self._as_input(img2ch)
        times = []
        if self.device.type == "cpu":
            self.generate(x)
            for _ in range(iters):
                t0 = time.perf_counter()
                self.generate(x)
                times.append(time.perf_counter() - t0)
            return float(np.median(times))
        with torch.cuda.device(self.device):
            self.generate(x)
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                self.generate(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
        return float(np.median(times))
