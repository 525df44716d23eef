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
host, parallel/distributed.global_mesh): each entry records the process
that drives it. A pipeline given the global tensor runs on ``localize``'s
part of it, over the mesh of this process's entries, as a process of a
JAX run computes only its addressable shards. This process's entries
must form one block of the mesh, and no 'y' or 'x' line (a chain a halo
runs along) may cross processes: the halos stay on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

CPU_SHARDS = 8  # the CPU default, as the JAX tests' jax_num_cpu_devices=8


class Mesh:
    """``devices``: an ndarray of torch.device, one axis per name.
    ``processes``: an ndarray of the same shape, the rank of the process
    that drives each entry, and ``process`` this process's rank; by
    default every entry is this process's. The entries of other processes
    name the devices on their own hosts."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 processes: Optional[np.ndarray] = None, process: int = 0):
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
        """This process's part: a mesh of the entries it drives."""
        if not self.spans_processes:
            return self
        return Mesh(self.devices[self.local_box()], self.axis_names, process=self.process)

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


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Tuple[str, ...] = ("y",),
    devices: Union[str, Sequence, None] = None,
) -> Mesh:
    """A mesh over the given devices, filled in order. ``devices``: None or
    "cuda" for the visible cards cuda:0..n-1; "cpu" for logical CPU shards
    (as many as the shape needs, CPU_SHARDS by default); or a list of
    devices, which may repeat one (logical shards of one card). Default
    shape: a 1-D mesh over every device. Raises ValueError when the shape
    needs more devices than there are."""
    if devices is None or devices == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif devices == "cpu":
        devs = [torch.device("cpu")] * (int(np.prod(shape)) if shape is not None else CPU_SHARDS)
    else:
        devs = [torch.device(d) for d in devices]
    if shape is None:
        shape = (len(devs),)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


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


def localize(x: torch.Tensor, mesh: Mesh, spec: Sequence[Optional[str]],
             along: Sequence[Optional[str]] = ()) -> Tuple[torch.Tensor, Mesh]:
    """What a pipeline runs on to compute this process's shards alone: on
    a mesh that spans processes, ``x`` (the global tensor, split by
    ``spec``) at ``local_index`` and the mesh of the entries this process
    drives, whose shards are the global mesh's at those entries, so the
    pipeline's result is the global one's at ``local_index``. ``along``:
    the axes halos run along (None: skipped), whose lines must lie within
    one process (whole_lines). On any other mesh, ``(x, mesh)``."""
    if not mesh.spans_processes:
        return x, mesh
    whole_lines(mesh, *along)
    return x[local_index(x.shape, mesh, spec)], mesh.local()


def whole_lines(mesh: Mesh, *axes: Optional[str]) -> None:
    """Raise ValueError where a line of the mesh along one of ``axes``
    (None: skipped) crosses processes: a halo along it would cross the
    network, which the port does not exchange."""
    for axis in axes:
        if axis is None or not mesh.spans_processes:
            continue
        mesh.size(axis)  # raises for a name the mesh lacks
        if mesh.crosses(axis):
            raise ValueError(f"mesh axis {axis!r} crosses processes ({mesh._layout()}): each {axis!r} line must "
                             f"lie within one process, so that its halos stay on the host")


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


def lines(mesh: Mesh, axis: str):
    """The mesh indices along ``axis``, one list per position on the other
    axes, each in order along the axis: the chains a halo runs along."""
    k = mesh.axis_names.index(axis)
    shape = mesh.devices.shape
    for other in np.ndindex(*(shape[:k] + shape[k + 1:])):
        yield [other[:k] + (i,) + other[k:] for i in range(shape[k])]


def per_shard(fn, *arrays: np.ndarray) -> np.ndarray:
    """fn on each shard's blocks of ``arrays``, every shard in turn (one
    phase of a pipeline, launched on each shard before the next phase)."""
    out = np.empty(arrays[0].shape, dtype=object)
    for idx in np.ndindex(*arrays[0].shape):
        out[idx] = fn(*(a[idx] for a in arrays))
    return out


def along(fn, blocks: np.ndarray, mesh: Mesh, axis: str, n_out: int = 1):
    """fn on each chain of blocks along ``axis`` (a list in axis order),
    returning a list per chain (or ``n_out`` lists); the results placed
    back at their blocks' mesh indices."""
    outs = [np.empty(blocks.shape, dtype=object) for _ in range(n_out)]
    for line in lines(mesh, axis):
        res = fn([blocks[i] for i in line])
        for k, r in enumerate((res,) if n_out == 1 else res):
            for i, v in zip(line, r):
                outs[k][i] = v
    return outs[0] if n_out == 1 else tuple(outs)
