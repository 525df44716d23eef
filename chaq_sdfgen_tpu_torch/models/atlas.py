"""Batched glyph-atlas SDF generation (chaq_sdfgen_tpu/models/atlas.py;
BASELINE config 5).

The reference processes one image per run; an atlas is a (N, H, W, 2)
stack of glyph images made into (N, H, W) uint8 SDF bitmaps with the
single-image CLI's bytes. It runs the EXACT pipeline (the OpenMP binary's
bytes) or BRUTE (the OpenCL binary's), as ``config.algorithm`` says; JFA
raises. On one device each of the pipeline's two kernels runs once over
the whole stack (ops/cuda_edt.py and ops/cuda_brute.py take (..., H, W));
over a ('data', 'y') mesh the batch is split over 'data' and rows over
'y' (parallel/sharded.sharded_hard_sdf_bytes, sharded_brute_sdf_bytes).
Over a mesh that spans processes (parallel/distributed.global_mesh, or
any layout whose 'y' lines cross them too), every process is given the
global stack and computes its own part of it: its 'data' rows, and of a
'y' line that crosses processes its own image rows, the halos' rows of
other processes' shards coming by point-to-point.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.config import Algorithm, SdfConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import hard_sdf_exact_from_bool, resolve_device
from chaq_sdfgen_tpu_torch.ops import cuda_brute, cuda_edt, threshold
from chaq_sdfgen_tpu_torch.parallel.distributed import check_mesh
from chaq_sdfgen_tpu_torch.parallel.mesh import Mesh, localize
from chaq_sdfgen_tpu_torch.parallel.sharded import sharded_brute_sdf_bytes, sharded_hard_sdf_bytes
from chaq_sdfgen_tpu_torch.utils.profiling import recording, span


def _as_stack(images) -> torch.Tensor:
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if images.dim() != 4 or images.shape[-1] != 2:
        raise ValueError(f"expected (N, H, W, 2) gray+alpha stack, got {tuple(images.shape)}")
    return images


def _check_algorithm(config: SdfConfig, runs) -> None:
    if config.algorithm not in runs:
        names = " and ".join(a.value for a in runs)
        raise ValueError(f"the atlas runs {names}, not {config.algorithm.value}")


def atlas_sdf(
    images,
    config: SdfConfig = SdfConfig(),
    mesh: Optional[Mesh] = None,
    sharding=None,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """(N, H, W, 2) uint8 (numpy or torch) -> (N, H, W) uint8 SDF bitmaps
    on the device they were computed on.

    ``config.algorithm``: EXACT (the OpenMP binary's bytes) or BRUTE (the
    OpenCL binary's: threshold > 127 always, ``invert`` the sign decider);
    JFA raises ValueError.
    Without a mesh: on ``device`` (default the first card; with no card,
    only an explicit ``device="cpu"`` runs), one launch of each of the
    pipeline's two kernels over the stack. With a mesh (parallel/mesh.Mesh):
    the batch over 'data' where the mesh has it, rows over 'y', the result
    joined on the mesh's first device (the mesh's devices decide where it
    runs). On a mesh that spans processes, ``images`` is the global stack, checked
    against the global mesh, and the result is this process's part of it
    (parallel/mesh.local_index: its images, and its image rows where 'y'
    crosses processes), joined on its first device.
    ``sharding``: alternatively a ShardingConfig, whose
    mesh is built over the cards (or logical CPU shards with
    ``device="cpu"``); mesh and sharding are mutually exclusive. Span
    ``sdf.atlas``."""
    if recording():
        with span("sdf.atlas"):
            return _atlas_sdf(images, config, mesh, sharding, device)
    return _atlas_sdf(images, config, mesh, sharding, device)


def _atlas_sdf(images, config: SdfConfig, mesh: Optional[Mesh], sharding, device) -> torch.Tensor:
    _check_algorithm(config, (Algorithm.EXACT, Algorithm.BRUTE))
    brute = config.algorithm == Algorithm.BRUTE
    # BRUTE thresholds > 127 always; invert flips its sign decider instead
    test_above = brute or not config.invert
    if sharding is not None:
        if mesh is not None:
            raise ValueError("pass either mesh or sharding, not both")
        mesh = sharding.build_mesh("cpu" if resolve_device(device).type == "cpu" else None)
    images = _as_stack(images)
    if mesh is None:
        b = threshold.hard_threshold(images.to(resolve_device(device)), channel=config.channel_offset,
                                     test_above=test_above)
        if brute:
            return cuda_brute.brute_sdf_bytes(b, config.spread, config.asymmetric, config.invert)
        return hard_sdf_exact_from_bool(b, config.spread, asymmetric=config.asymmetric,
                                        band=config.effective_band)
    n, h = images.shape[:2]
    check_mesh(mesh, n, h)
    batch_axis = "data" if "data" in mesh.axis_names else None
    # on a mesh that spans processes, this process's images from the threshold on
    images, mesh = localize(images, mesh, (batch_axis, "y", None, None))
    b = threshold.hard_threshold(images.to(mesh.devices.flat[0]), channel=config.channel_offset,
                                 test_above=test_above)
    if brute:
        return sharded_brute_sdf_bytes(b, config.spread, mesh, asymmetric=config.asymmetric,
                                       invert=config.invert, batch_axis=batch_axis)
    return sharded_hard_sdf_bytes(b, config.spread, mesh, asymmetric=config.asymmetric,
                                  band=config.effective_band, batch_axis=batch_axis)


def sweep_band(spreads: Sequence[int]) -> int:
    """The sweep's shared band: max(spreads) + 2 rounded up to 16."""
    return -(-(max(spreads) + 2) // 16) * 16


def atlas_sdf_spread_sweep(
    images,
    spreads,
    config: SdfConfig = SdfConfig(),
    band: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """(N, H, W, 2) uint8 + a list of spreads -> (len(spreads), N, H, W)
    uint8: the same atlas at several falloff ranges (mip-style levels,
    training curricula). Pass 1 runs once at one band for every spread
    (``band``, default sweep_band(spreads), JAX's), then pass 2 once per
    spread at that spread's own band, spread + 2, which clips the shared
    strips to what pass 1 at spread + 2 gives: byte for byte atlas_sdf at
    each spread, with each level walking no further than its own band.
    Raises ValueError for a band below max(spreads) + 2, whose strips
    would clip distances a level needs, and for any algorithm but EXACT,
    whose pass 1 is the one shared."""
    _check_algorithm(config, (Algorithm.EXACT,))
    images = _as_stack(images).to(resolve_device(device))
    spreads = [int(s) for s in spreads]
    if band is None:
        band = sweep_band(spreads)
    if band < max(spreads) + 2:
        raise ValueError(f"band {band} is below max(spreads) + 2 = {max(spreads) + 2}")
    b = threshold.hard_threshold(images, channel=config.channel_offset, test_above=not config.invert)
    din, dout = cuda_edt.row_distances_u8(b, band)
    # single-row images: the reference never applies the pass-2 sqrt
    apply_sqrt = b.shape[-2] > 1
    return torch.stack([
        cuda_edt.fused_pass2_bytes(din, dout, s, config.asymmetric, s + 2, apply_sqrt=apply_sqrt)
        for s in spreads
    ])
