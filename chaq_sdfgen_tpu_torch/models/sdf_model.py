"""SDF generator pipelines (chaq_sdfgen_tpu/models/sdf_model.py).

  hard_sdf_exact  -- OpenMP-binary semantics, byte-identical (Algorithm.EXACT)
  hard_sdf_brute  -- OpenCL-kernel semantics, byte-identical (Algorithm.BRUTE)
  hard_sdf_jfa    -- jump-flood variant (Algorithm.JFA)
  signed_distance_field_exact -- the signed exact full-range float field
  soft path       -- SDFGenerator(soft=SoftConfig(...)): the differentiable
                     field (ops/softsdf.py), on a declared gray range or
                     none (gray_range=None), at any spread

SDFGenerator(sharding=ShardingConfig(...)) runs the hard algorithms and the
soft field over a device mesh (parallel/sharded.py).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional, Union

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.config import Algorithm, SdfConfig, SoftConfig
from chaq_sdfgen_tpu_torch.ops import cuda_brute, cuda_edt, jfa, merge, softsdf, threshold
from chaq_sdfgen_tpu_torch.utils.profiling import recording, span


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


def hard_sdf_brute(
    img2ch: torch.Tensor,
    spread: int,
    asymmetric: bool = False,
    use_luminance: bool = False,
    invert: bool = False,
) -> torch.Tensor:
    """Full OpenCL-kernel pipeline (opencl/sdf.cl:193-224), byte-identical:
    threshold always > 127, the triangle candidate set (diagonal-exclusion
    quirk included); ``invert`` flips the sign decider, not the threshold.
    (..., H, W, 2) uint8 -> (..., H, W) uint8 on the input's device."""
    channel = 0 if use_luminance else 1
    b = threshold.hard_threshold(img2ch, channel=channel, test_above=True)
    return cuda_brute.brute_sdf_bytes(b, spread, asymmetric=asymmetric, invert=invert)


def hard_sdf_jfa(
    img2ch: torch.Tensor,
    spread: int,
    asymmetric: bool = False,
    channel: int = 1,
    test_above: bool = True,
    plus_one: bool = True,
) -> torch.Tensor:
    """Jump-flood pipeline: unclamped full-range nearest-seed distances (no
    band), merged and remapped like the OpenMP binary. Torch ops on the
    input's device (the JAX package has no kernel here either)."""
    b = threshold.hard_threshold(img2ch, channel=channel, test_above=test_above)
    d_in = jfa.jfa_distance(b, plus_one=plus_one)
    d_out = jfa.jfa_distance(torch.logical_not(b), plus_one=plus_one)
    return merge.remap_to_byte(merge.signed_merge(d_out, d_in), spread, asymmetric)


def signed_distance_field_exact(b: torch.Tensor) -> torch.Tensor:
    """Signed exact full-range distance field (float32, no spread clamp, no
    byte remap) of a (..., H, W) mask: positive outside the shape, -(d-1)
    inside (the OpenMP merge bias, openmp/sdfgen.c:98-106). Kernel
    ``edt_dist`` on both polarities of one pass 1 for a CUDA tensor, the
    plain versions on the CPU."""
    d_in, d_out = cuda_edt.exact_distance_fields(b)
    return merge.signed_merge(d_out, d_in)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device asked for, else the first CUDA device. Without a card
    and without an explicit request for the CPU this raises: the port
    never carries on on the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found (torch.cuda.is_available() is false); "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", 0)


class SDFGenerator:
    """Config-driven facade: construct once with an SdfConfig, call
    ``generate(image_2ch)`` for uint8 SDF bitmaps. PyTorch runs eagerly,
    so there is no compile cache to keep.

    soft: optional SoftConfig. generate() then runs the differentiable
    pipeline and returns the clamped soft byte map (truncated to uint8
    like the hard remap, openmp/sdfgen.c:94); generate_field() returns the
    raw float32 signed field.

    device: where the pipeline runs (default: the first CUDA device; with
    no card, only an explicit ``device="cpu"`` runs). Inputs are moved
    there; the result stays there.

    sharding: optional ShardingConfig. The hard algorithms, or with
    ``soft`` the soft field (sharded.sharded_soft_sdf_field), then run over
    its mesh (parallel/sharded.py): on ``device="cpu"`` mesh_shape logical
    CPU shards, on a card distinct cards cuda:0..n-1, raising when there
    are too few or when ``device`` names another card than cuda:0. The
    result is joined onto the mesh's first device. In a torch.distributed
    run of several processes the mesh spans every process's devices
    (parallel/mesh.make_mesh), each process is given the whole image, and
    ``generate`` and ``generate_field`` return its part of the result, at
    ``own_index`` (as a JAX process holds its addressable shards), on its
    first device of the mesh."""

    def __init__(
        self,
        config: SdfConfig = SdfConfig(),
        soft: Optional[SoftConfig] = None,
        sharding=None,
        device: Union[str, torch.device, None] = None,
    ):
        self.config = config
        self.soft = soft
        self.device = resolve_device(device)
        self.sharding = sharding
        self._mesh = None
        if sharding is not None:
            if self.device.type == "cuda" and self.device.index not in (None, 0):
                raise ValueError(
                    f"a sharded run spans the cards cuda:0..n-1 and returns on cuda:0; "
                    f"device {self.device} is not the mesh's first card"
                )
            self._mesh = sharding.build_mesh("cpu" if self.device.type == "cpu" else None)
            self.device = self._mesh.local().devices.flat[0]

    def own_index(self, shape) -> tuple:
        """The global index of this process's part of a (..., H, W) result
        of ``generate``: all of it but on a mesh that spans processes."""
        shape = tuple(shape)
        if self._mesh is None or not self._mesh.spans_processes:
            return tuple(slice(0, n) for n in shape)
        from chaq_sdfgen_tpu_torch.parallel.mesh import image_spec, local_index

        sh = self.sharding
        spec = image_spec(len(shape), sh.y_axis, sh.x_axis, sh.data_axis if len(shape) > 2 else None)
        return local_index(shape, self._mesh, spec)

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
        ``self.device``. Span ``sdf.generate``."""
        if recording():
            with span("sdf.generate"):
                return self._generate(img2ch)
        return self._generate(img2ch)

    def _generate(self, img2ch) -> torch.Tensor:
        cfg = self.config
        x = self._as_input(img2ch)
        if self.soft is not None:
            v = merge.soft_remap(self._field(x), cfg.spread, cfg.asymmetric, clamp=self.soft.clamp)
            # truncating u8 cast, matching the hard remap (sdfgen.c:94)
            return torch.clamp(v, 0.0, 255.0).to(torch.int32).to(torch.uint8)
        if self._mesh is not None:
            return self._sharded(x)
        if cfg.algorithm == Algorithm.BRUTE:
            return hard_sdf_brute(
                x,
                spread=cfg.spread,
                asymmetric=cfg.asymmetric,
                use_luminance=cfg.channel_offset == 0,
                invert=cfg.invert,
            )
        if cfg.algorithm == Algorithm.JFA:
            return hard_sdf_jfa(
                x,
                spread=cfg.spread,
                asymmetric=cfg.asymmetric,
                channel=cfg.channel_offset,
                test_above=not cfg.invert,
                plus_one=cfg.jfa_plus_one,
            )
        return hard_sdf_exact(
            x,
            spread=cfg.spread,
            asymmetric=cfg.asymmetric,
            channel=cfg.channel_offset,
            test_above=not cfg.invert,
            band=cfg.effective_band,
        )

    def _sharded(self, x: torch.Tensor) -> torch.Tensor:
        """The hard pipelines over the mesh (JAX _sharded_pipeline_fn)."""
        from chaq_sdfgen_tpu_torch.parallel import sharded

        cfg, sh, mesh = self.config, self.sharding, self._mesh
        kw = dict(y_axis=sh.y_axis, x_axis=sh.x_axis, halo=sh.halo_impl)
        if cfg.algorithm == Algorithm.BRUTE:
            # BRUTE thresholds > 127 always; invert flips the sign decider
            b = threshold.hard_threshold(x, channel=cfg.channel_offset, test_above=True)
            return sharded.sharded_brute_sdf_bytes(
                b, cfg.spread, mesh, asymmetric=cfg.asymmetric, invert=cfg.invert,
                batch_axis=sh.data_axis if b.dim() > 2 else None, **kw)
        b = threshold.hard_threshold(x, channel=cfg.channel_offset, test_above=not cfg.invert)
        if cfg.algorithm == Algorithm.JFA:
            kw.pop("halo")
            d_in = sharded.sharded_jfa_distance(b, mesh, plus_one=cfg.jfa_plus_one, **kw)
            d_out = sharded.sharded_jfa_distance(torch.logical_not(b), mesh, plus_one=cfg.jfa_plus_one, **kw)
            return merge.remap_to_byte(merge.signed_merge(d_out, d_in), cfg.spread, cfg.asymmetric)
        return sharded.sharded_hard_sdf_bytes(
            b, cfg.spread, mesh, asymmetric=cfg.asymmetric, band=cfg.effective_band,
            batch_axis=sh.data_axis if b.dim() > 2 else None, **kw)

    def generate_field(self, img2ch) -> torch.Tensor:
        """Raw float32 signed soft field (pre-remap) of (..., H, W, 2) u8
        images: the differentiable product. Requires a SoftConfig."""
        if self.soft is None:
            raise ValueError("generate_field needs SDFGenerator(soft=SoftConfig())")
        return self._field(self._as_input(img2ch))

    def _field(self, x: torch.Tensor) -> torch.Tensor:
        """The soft field, over the mesh when there is one (JAX
        _soft_field_fn)."""
        cfg, soft, sh = self.config, self.soft, self.sharding
        gray = x[..., cfg.channel_offset].to(torch.float32)
        kw = dict(tau=soft.tau, temperature=soft.temperature, eps=soft.eps, test_above=not cfg.invert,
                  band=cfg.effective_band, gray_range=soft.gray_range)
        if self._mesh is not None:
            from chaq_sdfgen_tpu_torch.parallel import sharded

            return sharded.sharded_soft_sdf_field(
                gray, cfg.spread, self._mesh, y_axis=sh.y_axis, x_axis=sh.x_axis,
                batch_axis=sh.data_axis if gray.dim() > 2 else None, halo=sh.halo_impl, **kw)
        return softsdf.soft_sdf_field(gray, cfg.spread, **kw)

    def kernel_time(self, img2ch, k1: int = 4, k2: int = 36, iters: Optional[int] = None) -> float:
        """Seconds per pipeline run on ``self.device`` (the counterpart of
        the reference's OpenCL event profiling, opencl/main.cpp:333-356),
        after one warm-up run. By default the JAX package's two-count slope:
        ``k1`` and then ``k2`` back-to-back runs are timed, each count the
        least of two tries, and the answer is (t_k2 - t_k1) / (k2 - k1),
        which cancels what a timed window costs once (at least 1e-9 s / (k2
        - k1)). With ``iters``, the median of that many single runs
        instead. CUDA events time a CUDA device; the host clock times the
        CPU, where a run is synchronous."""
        if iters is None and k2 <= k1:
            raise ValueError(f"kernel_time: k2 ({k2}) must exceed k1 ({k1})")
        x = self._as_input(img2ch)
        on_cpu = self.device.type == "cpu"

        def window(runs: int) -> float:  # seconds for ``runs`` back-to-back runs
            if on_cpu:
                t0 = time.perf_counter()
                for _ in range(runs):
                    self.generate(x)
                return time.perf_counter() - t0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(runs):
                self.generate(x)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        with contextlib.nullcontext() if on_cpu else torch.cuda.device(self.device):
            self.generate(x)
            if iters is not None:
                return float(np.median([window(1) for _ in range(iters)]))
            t1 = min(window(k1) for _ in range(2))
            t2 = min(window(k2) for _ in range(2))
        return max(t2 - t1, 1e-9) / (k2 - k1)
