"""Mesh construction and startup checks for the batched tier
(chaq_sdfgen_tpu/parallel/distributed.py).

One process drives every shard (parallel/mesh.py), so ``global_mesh``
spans the devices of this host: the batch over 'data', rows over 'y'. A
run of several processes (torch.distributed initialised over more than
one) is refused rather than given a mesh of this host alone; the
multi-host form and ``initialize`` are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from chaq_sdfgen_tpu_torch.parallel.mesh import CPU_SHARDS, Mesh, make_mesh


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_mesh(
    y_per_host: Optional[int] = None,
    data_axis: bool = True,
    devices: Union[str, Sequence, None] = None,
) -> Mesh:
    """A ('data', 'y') mesh over this host's devices: rows over
    ``y_per_host`` of them (all by default), the batch over the rest.
    ``devices``: the visible cards (None or "cuda"), "cpu" for CPU_SHARDS
    logical CPU shards, or a list (parallel/mesh.make_mesh). ``data_axis``
    is accepted for the JAX signature, whose mesh always has both axes.
    Raises ValueError when ``y_per_host`` does not divide the devices,
    NotImplementedError in a run of several processes."""
    del data_axis
    if _world_size() > 1:
        raise NotImplementedError(
            "global_mesh over several processes is not ported (ROADMAP item 11c); "
            "one process drives every device of a host"
        )
    if devices is None or devices == "cuda":
        from chaq_sdfgen_tpu_torch.models.sdf_model import resolve_device

        resolve_device(None)  # raises without a card
        n = torch.cuda.device_count()
    elif devices == "cpu":
        n = CPU_SHARDS
    else:
        devices = list(devices)
        n = len(devices)
    if y_per_host is None:
        y_per_host = n
    if y_per_host < 1 or n % y_per_host:
        raise ValueError(f"y_per_host={y_per_host} does not divide devices/host={n}")
    return make_mesh((n // y_per_host, y_per_host), ("data", "y"), devices)


def check_mesh(mesh: Mesh, batch: int, height: int) -> None:
    """Startup checks: the batch divisible by the 'data' extent and the
    height by the 'y' extent, with an actionable message each (the
    reference exits with raw errors, openmp/sdfgen.c:24-30)."""
    axes = mesh.shape
    if "data" in axes and batch % axes["data"] != 0:
        raise ValueError(f"batch {batch} not divisible by data-axis size {axes['data']}")
    if "y" in axes and height % axes["y"] != 0:
        raise ValueError(f"image height {height} not divisible by y-axis size {axes['y']}")
