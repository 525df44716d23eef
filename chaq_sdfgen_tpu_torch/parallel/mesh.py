"""Device meshes for the sharded tier (chaq_sdfgen_tpu/parallel/mesh.py).

One process drives every shard, as ``jax.shard_map`` does: a ``Mesh`` is
an ndarray of ``torch.device`` with one name per axis, and a sharded
tensor is an ndarray of the same shape holding each shard's block on its
device. Axis 'y' shards image rows, 'x' image columns (a 2-D tile mesh)
and 'data' the batch.

A mesh may name one device several times: n logical shards of one card,
or of the CPU, stand in for the JAX tests' virtual CPU devices and run
every shard, halo and kernel on one device. On distinct cards the same
code runs the shards on each card.

A mesh may span the processes of a torch.distributed run (one process a
host; ``make_mesh`` in such a run lays out every process's devices in
rank order for its default device sets, as ``jax.devices()`` does,
``spanning_mesh`` over each process's own list, and
parallel/distributed.global_mesh as ('data', 'y')): each entry records
the process that drives it. A pipeline given the global tensor runs on
``localize``'s part of it, over the mesh of this process's entries, as a
process of a JAX run computes only its addressable shards. This process's
entries must form one block of the mesh. That part remembers where it
lies in the global mesh (``Mesh.origin``, ``Mesh.offset``): a 'y' or 'x'
line of it that continues in other processes' entries takes the rows its
halos need from their shards by torch.distributed point-to-point
(parallel/halo.py's plans read the origin's layout), and its shards'
positions, which decide where the image ends, are global ones
(``Mesh.position``, ``Mesh.extent``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

CPU_SHARDS = 8  # the CPU default, as the JAX tests' jax_num_cpu_devices=8


class Mesh:
    """``devices``: an ndarray of torch.device, one axis per name.
    ``processes``: an ndarray of the same shape, the rank of the process
    that drives each entry, and ``process`` this process's rank; by
    default every entry is this process's. The entries of other processes
    name the devices on their own hosts. ``origin`` and ``offset``: for
    this process's part of a mesh that spans processes (``local``), that
    mesh and the global index of this part's first entry."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 processes: Optional[np.ndarray] = None, process: int = 0,
                 origin: Optional["Mesh"] = None, offset: Optional[Sequence[int]] = None):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs {devices.ndim} distinct axis names, "
                             f"got {axis_names}")
        processes = np.full(devices.shape, process) if processes is None else np.asarray(processes)
        if processes.shape != devices.shape:
            raise ValueError(f"processes of shape {processes.shape} for a mesh of shape {devices.shape}")
        self.devices = devices
        self.axis_names = axis_names
        self.processes = processes
        self.process = process
        self.origin = origin
        self.offset = tuple(int(o) for o in offset) if offset is not None else (0,) * devices.ndim

    @property
    def spans_processes(self) -> bool:
        """Whether other processes drive some of the entries."""
        return bool((self.processes != self.process).any())

    def crosses(self, axis: str) -> bool:
        """Whether the process changes along ``axis``: a line of the mesh
        along it crosses processes."""
        k = self.axis_names.index(axis)
        return bool((self.processes != self.processes.take([0], axis=k)).any())

    def local_box(self) -> Tuple[slice, ...]:
        """The block of mesh indices this process drives, a slice per axis.
        Raises ValueError when it drives none or they form no block."""
        own = np.argwhere(self.processes == self.process)
        if not len(own):
            raise ValueError(f"process {self.process} drives no entry of {self!r}")
        lo, hi = own.min(0), own.max(0) + 1
        if len(own) != int(np.prod(hi - lo)):
            raise ValueError(f"the entries of process {self.process} form no block of the mesh: {self._layout()}")
        return tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))

    def local(self) -> "Mesh":
        """This process's part: a mesh of the entries it drives, which
        remembers this mesh as its ``origin`` and its box's corner as its
        ``offset``."""
        if not self.spans_processes:
            return self
        box = self.local_box()
        return Mesh(self.devices[box], self.axis_names, process=self.process, origin=self,
                    offset=[b.start for b in box])

    def extent(self, axis: str) -> int:
        """The global extent of ``axis``: the origin's on a part, else size."""
        return (self.origin or self).size(axis)

    def position(self, idx: Sequence[int]) -> Tuple[int, ...]:
        """The global mesh index of entry ``idx`` of this mesh."""
        return tuple(int(i) + o for i, o in zip(idx, self.offset))

    def _layout(self) -> str:
        return f"axes {self.shape}, the process of each entry {self.processes.tolist()}"

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: Optional[str]) -> int:
        """The extent of ``axis`` (1 for None); raises for a name the mesh lacks."""
        if axis is None:
            return 1
        if axis not in self.axis_names:
            raise ValueError(f"mesh axes {self.axis_names} have no {axis!r}")
        return self.shape[axis]

    def __repr__(self) -> str:
        procs = f", processes={self.processes.tolist()}" if self.spans_processes else ""
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{procs})"


def host_devices(devices: Union[str, Sequence, None], count: Optional[int] = None) -> list:
    """This process's devices: None or "cuda" its visible cards
    cuda:0..n-1; "cpu" ``count`` logical CPU shards (CPU_SHARDS by
    default); or a list of devices, which may repeat one (logical shards of
    one card)."""
    if devices is None or devices == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if devices == "cpu":
        return [torch.device("cpu")] * (CPU_SHARDS if count is None else count)
    return [torch.device(d) for d in devices]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("y",),
    devices: Union[str, Sequence, None] = None,
) -> Mesh:
    """A mesh over the given devices, filled in order. ``devices``: None or
    "cuda" the visible cards, "cpu" logical CPU shards (as many as the
    shape needs, CPU_SHARDS by default), or a list of devices, which may
    repeat one (host_devices). In an initialized torch.distributed run of
    several processes the default sets (None, "cuda", "cpu") are every
    process's, as ``jax.devices()`` holds them (spanning_mesh; "cpu" then
    gives each process its share of the shape, rounded up); a list is this
    process's alone, and so is the mesh over it. Default shape: a 1-D mesh over every device. Raises
    ValueError when the shape needs more devices than there are."""
    from chaq_sdfgen_tpu_torch.parallel import distributed

    world = distributed.world_size()
    span = world > 1 and (devices is None or isinstance(devices, str))
    count = None if shape is None else -(-int(np.prod(shape)) // (world if span else 1))
    if span:
        return spanning_mesh(shape, axis_names, host_devices(devices, count))
    rank = torch.distributed.get_rank() if world > 1 else 0
    return _filled(shape, axis_names, host_devices(devices, count), [rank], rank)


def spanning_mesh(
    shape: Optional[Tuple[int, ...]],
    axis_names: Tuple[str, ...],
    devices: Sequence,
) -> Mesh:
    """A mesh over the devices of every process of an initialized
    torch.distributed run, filled in rank order: ``devices`` this
    process's (a list, which may repeat a device), their names exchanged
    once in one collective every process makes; each entry records its
    process. Default shape: a 1-D mesh over every device. Raises ValueError
    when the shape needs more devices than there are."""
    from chaq_sdfgen_tpu_torch.parallel import distributed

    names = distributed.gather([str(torch.device(d)) for d in devices])
    return _filled(shape, axis_names, [torch.device(d) for part in names for d in part],
                   [p for p, part in enumerate(names) for _ in part], torch.distributed.get_rank())


def _filled(shape, axis_names, devs: list, procs: list, rank: int) -> Mesh:
    if shape is None:
        shape = (len(devs),)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    processes = np.asarray((procs * n)[:n] if len(procs) == 1 else procs[:n]).reshape(tuple(shape))
    return Mesh(arr.reshape(tuple(shape)), axis_names, processes, rank)


def image_spec(ndim: int, y_axis: str, x_axis: Optional[str] = None,
               batch_axis: Optional[str] = None) -> Tuple[Optional[str], ...]:
    """The spec of a (..., H, W) image tensor: rows over ``y_axis``, columns
    over ``x_axis`` (or whole), the first dim over ``batch_axis`` (the
    counterpart of PartitionSpec(batch_axis, y_axis, x_axis))."""
    if ndim < 2:
        raise ValueError(f"expected (..., H, W), got {ndim} dims")
    lead = [None] * (ndim - 2)
    if batch_axis is not None:
        if ndim < 3:
            raise ValueError("a batch axis needs a (N, H, W) input")
        lead[0] = batch_axis
    return tuple(lead) + (y_axis, x_axis)


def _check_spec(shape: Tuple[int, ...], mesh: Mesh, spec: Sequence[Optional[str]]) -> Tuple[Optional[str], ...]:
    """``spec`` as a tuple, after checking it against a tensor's shape."""
    spec = tuple(spec)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a tensor of shape {shape}")
    named = [a for a in spec if a is not None]
    if len(set(named)) != len(named):
        raise ValueError(f"spec {spec} names an axis twice")
    for dim, ax in enumerate(spec):
        if ax is not None and shape[dim] % mesh.size(ax):
            raise ValueError(f"dimension {dim} of shape {shape} ({shape[dim]}) is not "
                             f"divisible by mesh axis {ax!r} ({mesh.size(ax)})")
    return spec


def local_index(shape: Sequence[int], mesh: Mesh, spec: Sequence[Optional[str]]) -> Tuple[slice, ...]:
    """The global index of this process's part of a tensor of ``shape``
    split over ``mesh`` by ``spec``, a slice per dim (the counterpart of a
    JAX shard's ``index``): the rows of its entries of the mesh."""
    shape = tuple(shape)
    spec = _check_spec(shape, mesh, spec)
    box = mesh.local_box()
    index = []
    for dim, ax in enumerate(spec):
        if ax is None:
            index.append(slice(0, shape[dim]))
        else:
            k = mesh.axis_names.index(ax)
            step = shape[dim] // mesh.devices.shape[k]
            index.append(slice(box[k].start * step, box[k].stop * step))
    return tuple(index)


def localize(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> Tuple[torch.Tensor, Mesh]:
    """What a pipeline runs on to compute this process's shards alone: on
    a mesh that spans processes, ``x`` (the global tensor, split by
    ``spec``) at ``local_index`` and the mesh of the entries this process
    drives (``Mesh.local``), whose shards are the global mesh's at those
    entries, so the pipeline's result is the global one's at
    ``local_index``; its halos reach other processes' shards where its
    lines cross them. On any other mesh, ``(x, mesh)``."""
    if not mesh.spans_processes:
        return x, mesh
    return x[local_index(x.shape, mesh, spec)], mesh.local()


def shard(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]]) -> np.ndarray:
    """Split ``x`` over the mesh (the port's NamedSharding): spec names a
    mesh axis (or None, whole) for each dim of x. Returns an ndarray shaped
    like mesh.devices whose entry at a mesh index is that shard's block,
    contiguous, on its device; a mesh axis the spec does not name holds a
    copy of the same block at each of its indices. Raises ValueError where
    a dim is not divisible by its axis."""
    spec = _check_spec(tuple(x.shape), mesh, spec)
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(*mesh.devices.shape):
        blk = x
        for dim, ax in enumerate(spec):
            if ax is not None:
                k = mesh.axis_names.index(ax)
                step = x.shape[dim] // mesh.devices.shape[k]
                blk = blk.narrow(dim, idx[k] * step, step)
        out[idx] = blk.to(mesh.devices[idx]).contiguous()
    return out


def unshard(blocks: np.ndarray, mesh: Mesh, spec: Sequence[Optional[str]],
            device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Join per-shard blocks (as ``shard`` makes them) into one tensor on
    ``device``, by default the mesh's first device; of a mesh axis that
    the spec does not name, index 0 is read."""
    spec = tuple(spec)
    device = torch.device(device) if device is not None else mesh.devices.flat[0]
    kept = [ax for ax in mesh.axis_names if ax in spec]
    arr = blocks[tuple(slice(None) if ax in spec else 0 for ax in mesh.axis_names)]

    def join(a, axes):
        if not axes:
            return a.to(device)
        return torch.cat([join(a[i], axes[1:]) for i in range(a.shape[0])], dim=spec.index(axes[0]))

    return join(arr, kept)


def mesh_array(items: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    """An object ndarray of ``shape`` holding ``items`` (flat order) as
    they are: a tensor stays one entry."""
    out = np.empty(math.prod(shape), dtype=object)
    for i, item in enumerate(items):
        out[i] = item
    return out.reshape(shape)


def per_shard(fn, *arrays: np.ndarray) -> np.ndarray:
    """fn on each shard's blocks of ``arrays``, every shard in turn (one
    phase of a pipeline, launched on each shard before the next phase)."""
    out = np.empty(arrays[0].shape, dtype=object)
    for idx in np.ndindex(*arrays[0].shape):
        out[idx] = fn(*(a[idx] for a in arrays))
    return out
