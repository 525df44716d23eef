"""Multi-host bring-up, the global mesh and startup checks for the batched
tier (chaq_sdfgen_tpu/parallel/distributed.py).

One process a host drives every device of its host (parallel/mesh.py).
``initialize`` joins the processes of a run into one torch.distributed
group; ``global_mesh`` then lays out every process's devices, process by
process, as ('data', 'y'): the batch over the hosts (the network between
them), the rows over the devices of each host. ``make_mesh`` in such a
run lays any shape over every process's devices in rank order, so a 'y'
(or 'x') line may cross hosts. Each process computes its own entries of
a mesh alone; a halo that a shard needs from another process's shard
comes by point-to-point over the group (parallel/halo.py), and its
cotangent goes back the same way.
"""

from __future__ import annotations

import datetime
import logging
from typing import Optional, Sequence, Union

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.parallel.mesh import Mesh, host_devices, make_mesh

log = logging.getLogger("chaq_sdfgen_tpu_torch")

# how long a process waits in a collective for the others: a process that
# fails or hangs ends its peers' waits within this
TIMEOUT = datetime.timedelta(seconds=120)


def world_size() -> int:
    """The processes of the run: 1 outside an initialized group."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def gather(value) -> list:
    """``value`` of every process, in rank order (one collective)."""
    out = [None] * world_size()
    torch.distributed.all_gather_object(out, value)
    return out


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join a run of ``num_processes`` processes, one a host, as process
    ``process_id``, through the coordinator at ``coordinator_address``
    ("host:port", which process 0 listens on; None: torch.distributed's
    environment variables). Does nothing for a single process.
    ``backend``: "nccl" by default where the process has cards, "gloo"
    without; "gloo" may be named for cards too (its collectives stage
    through the host). A backend that fails raises: none is swapped in."""
    if num_processes is None or num_processes <= 1:
        log.debug("distributed: single process, skipping initialize")
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    torch.distributed.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}" if coordinator_address is not None else None,
        world_size=num_processes,
        rank=process_id if process_id is not None else -1,
        timeout=TIMEOUT,
    )
    local = torch.cuda.device_count()
    log.info("distributed: process %d/%d (%s), %d local / %d global cards; halos across processes by "
             "point-to-point over %s", torch.distributed.get_rank(), num_processes, backend, local,
             sum(gather(local)), backend)


def global_mesh(
    y_per_host: Optional[int] = None,
    data_axis: bool = True,
    devices: Union[str, Sequence, None] = None,
) -> Mesh:
    """A ('data', 'y') mesh over the devices of every process of the run:
    rows over ``y_per_host`` devices of a host (all by default), the batch
    over the rest, the devices laid out process by process, so that with
    ``y_per_host`` below a host's count a process holds several
    consecutive 'data' rows. ``devices``: this host's devices (None or
    "cuda" the visible cards, "cpu" CPU_SHARDS logical CPU shards, or a
    list, parallel/mesh.host_devices). In a run of several processes the
    counts are exchanged once and must be equal. ``data_axis`` is accepted
    for the JAX signature, whose mesh always has both axes. Raises
    ValueError when ``y_per_host`` does not divide a host's devices."""
    del data_axis
    if devices is None or devices == "cuda":
        from chaq_sdfgen_tpu_torch.models.sdf_model import resolve_device

        resolve_device(None)  # raises without a card
    host = host_devices(devices)
    n = len(host)
    hosts = world_size()
    if hosts > 1:
        counts = gather(n)
        if len(set(counts)) != 1:
            raise ValueError(f"the processes drive unequal device counts {counts}: global_mesh needs one count a "
                             f"host")
    if y_per_host is None:
        y_per_host = n
    if y_per_host < 1 or n % y_per_host:
        raise ValueError(f"y_per_host={y_per_host} does not divide devices/host={n}")
    shape = (hosts * n // y_per_host, y_per_host)
    if hosts == 1:
        return make_mesh(shape, ("data", "y"), devices)
    devs = np.empty(hosts * n, dtype=object)
    devs[:] = host * hosts
    procs = np.repeat(np.arange(hosts), n)
    return Mesh(devs.reshape(shape), ("data", "y"), procs.reshape(shape), torch.distributed.get_rank())


def check_mesh(mesh: Mesh, batch: int, height: int) -> None:
    """Startup checks: the batch divisible by the 'data' extent and the
    height by the 'y' extent, with an actionable message each (the
    reference exits with raw errors, openmp/sdfgen.c:24-30)."""
    axes = mesh.shape
    if "data" in axes and batch % axes["data"] != 0:
        raise ValueError(f"batch {batch} not divisible by data-axis size {axes['data']}")
    if "y" in axes and height % axes["y"] != 0:
        raise ValueError(f"image height {height} not divisible by y-axis size {axes['y']}")
