"""Trainable soft-SDF model and its training step
(chaq_sdfgen_tpu/models/soft_model.py): flax and optax become an
``nn.Module`` and ``torch.optim.Adam``.

A small set of learnable scalars controls the thresholding front end, and
gradients flow through the soft EDT back to both the parameters and the
input pixels. Parameters (all scalar, broadcast over pixels):
  threshold_bias -- learnable shift of the 127.5 threshold midpoint
  log_tau        -- learnable threshold temperature
  channel_mix    -- logits mixing the gray and alpha channels into the
                    tested value

The model passes no gray_range, so its field takes the undeclared-range
paths of ops/softsdf.py: up to band 112 the runtime gate (the
declared-range kernels with a runtime shift while the mixed values stay in
gamut, the adaptive kernels otherwise), above it the composed path.
``params_from_jax`` carries a flax parameter tree over, and
``opt_state_from_jax`` an optax.adam state, so that a JAX training run
resumes here (models/checkpoint.py). With ``mesh`` the
field runs over a device mesh (parallel/sharded.sharded_soft_sdf_field,
the undeclared tiers: the adaptive kernels or the composed path), the
batch over ``batch_axis``, and the parameters live on the mesh's first
device. Over a mesh that spans processes (parallel/distributed.global_mesh,
the batch over 'data'), each process is given the global batch, computes
its own rows and returns them; its training step sums the parameters'
gradients over the processes (one all_reduce a step), so the parameters
stay the same in every process.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.config import SoftConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import resolve_device
from chaq_sdfgen_tpu_torch.ops import softsdf
from chaq_sdfgen_tpu_torch.parallel.mesh import local_index, localize

PARAM_NAMES = ("threshold_bias", "log_tau", "channel_mix")


class SoftSDFModel(torch.nn.Module):
    """Differentiable SDF generator with a learnable threshold front end.

    forward(img2ch float32 (..., H, W, 2)) -> signed soft SDF (..., H, W).
    The parameters live on ``device`` (default: the first CUDA device;
    with no card, only an explicit ``device="cpu"`` runs), or with a
    ``mesh`` (parallel/mesh.Mesh) on its first device (this process's);
    ``batch_axis`` names the mesh axis that shards the batch of a (N, H,
    W, 2) input. On a mesh that spans processes, forward takes the global
    batch and returns this process's rows (parallel/mesh.local_index)."""

    def __init__(self, spread: int = 16, soft: SoftConfig = SoftConfig(), mesh=None,
                 device: Union[str, torch.device, None] = None, batch_axis: Optional[str] = None):
        super().__init__()
        self.spread = spread
        self.soft = soft
        self.mesh = mesh
        self.batch_axis = batch_axis
        if mesh is not None and mesh.spans_processes:
            # each row computed by one process alone: only the batch axis may cross them
            crossing = [a for a in mesh.axis_names if a != batch_axis and mesh.crosses(a)]
            if batch_axis is None or crossing:
                raise ValueError(f"mesh axis {(crossing or mesh.axis_names)[0]!r} crosses processes "
                                 f"({mesh._layout()}): on a mesh that spans processes the batch axis "
                                 f"(batch_axis={batch_axis!r}) must be the one that crosses them")
        first = mesh.local().devices.flat[0] if mesh is not None else None
        dev = first if mesh is not None and device is None else resolve_device(device)
        if mesh is not None and dev != first:
            raise ValueError(f"the parameters live on the mesh's first device {first}, not {dev}")
        f32 = dict(dtype=torch.float32, device=dev)
        self.threshold_bias = torch.nn.Parameter(torch.zeros((), **f32))
        self.log_tau = torch.nn.Parameter(torch.log(torch.tensor(soft.tau, **f32)))
        self.channel_mix = torch.nn.Parameter(torch.tensor([0.0, 4.0], **f32))

    def own_rows(self, shape) -> tuple:
        """The global index of this process's rows of a (..., H, W[, 2])
        tensor of ``shape`` (all of it but on a mesh that spans processes)."""
        spec = (self.batch_axis,) + (None,) * (len(shape) - 1)
        return local_index(shape, self.mesh, spec) if self._spans else tuple(slice(None) for _ in shape)

    @property
    def _spans(self) -> bool:
        return self.mesh is not None and self.mesh.spans_processes

    def forward(self, img2ch: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if mesh is not None:
            # on a mesh that spans processes, this process's rows from the front end on
            spec = (self.batch_axis,) + (None,) * (img2ch.dim() - 1)
            img2ch, mesh = localize(img2ch, mesh, spec)
        mix = torch.softmax(self.channel_mix, dim=0)
        gray = (img2ch.to(torch.float32) * mix).sum(-1) - self.threshold_bias
        tau = torch.exp(self.log_tau)
        # fold the learnable tau into the pixel values, so that the kernels
        # run at the configured tau: logits (v - 127.5) / tau_static
        v = (gray - 127.5) / tau * self.soft.tau + 127.5
        kw = dict(tau=self.soft.tau, temperature=self.soft.temperature, eps=self.soft.eps)
        if mesh is not None:
            from chaq_sdfgen_tpu_torch.parallel import sharded

            return sharded.sharded_soft_sdf_field(v, self.spread, mesh, batch_axis=self.batch_axis, **kw)
        return softsdf.soft_sdf_field(v, self.spread, **kw)


def create_train_state(model: SoftSDFModel, example: torch.Tensor = None,
                       lr: float = 1e-2) -> torch.optim.Adam:
    """Adam over the model's parameters with optax.adam's defaults (b1
    0.9, b2 0.999, eps 1e-8 added outside the square root). The module
    holds its parameters, so ``example`` (flax's init input) is not read;
    it stays for the JAX signature."""
    del example
    return _adam(model.parameters(), lr)


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_train_step(model: SoftSDFModel, opt: torch.optim.Optimizer):
    """train_step(img2ch, target) -> loss: the mean squared error between
    the model's signed soft field and ``target``, its gradient, and one
    optimizer step (in place on the model's parameters). On a mesh that
    spans processes both are the global batch: each process's loss is its
    rows' sum of squares over the global element count, and one
    all_reduce sums the parameters' gradients and the losses over the
    processes before the step, which returns the global loss."""
    params = list(model.parameters())

    def train_step(img2ch: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        if not model._spans:
            loss = torch.mean((model(img2ch) - target) ** 2)
            loss.backward()
        else:
            pred = model(img2ch)
            loss = ((pred - target[model.own_rows(target.shape)].to(pred.device)) ** 2).sum() / target.numel()
            loss.backward()
            loss = _sum_over_processes(params, loss.detach())
        opt.step()
        return loss.detach()

    return train_step


def _sum_over_processes(params: list, loss: torch.Tensor) -> torch.Tensor:
    """Sum the parameters' gradients (in place) and ``loss`` over the
    processes, flattened into one tensor and one all_reduce; returns the
    summed loss."""
    flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
    torch.distributed.all_reduce(flat)
    at = 0
    for p in params:
        p.grad.copy_(flat[at : at + p.numel()].view_as(p.grad))
        at += p.numel()
    return flat[at]


def params_from_jax(flax_params: Mapping[str, Any]) -> dict:
    """A flax ``{'params': {...}}`` tree of SoftSDFModel parameters (arrays
    or anything numpy reads) -> a state_dict for the port's SoftSDFModel,
    float32 CPU tensors; ``load_state_dict`` moves them to the model's
    device. Reads only numpy."""
    if "params" not in flax_params:
        raise ValueError("params_from_jax: expected a flax tree {'params': {...}}")
    tree = flax_params["params"]
    missing = [k for k in PARAM_NAMES if k not in tree]
    extra = sorted(set(tree) - set(PARAM_NAMES))
    if missing or extra:
        raise ValueError(f"params_from_jax: missing {missing}, unexpected {extra}")
    shapes = {"threshold_bias": (), "log_tau": (), "channel_mix": (2,)}
    out = {}
    for k in PARAM_NAMES:
        a = np.asarray(tree[k], dtype=np.float32)
        if a.shape != shapes[k]:
            raise ValueError(f"params_from_jax: {k} has shape {a.shape}, expected {shapes[k]}")
        out[k] = torch.from_numpy(a.copy())
    return out


def _adam_moments(opt_state: Any):
    """(count, mu, nu) of the first Adam state in an optax state: the
    ScaleByAdamState itself, or a chain tuple (as optax.adam builds) that
    holds it; else None."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    for part in opt_state if isinstance(opt_state, (list, tuple)) else ():
        found = _adam_moments(part)
        if found is not None:
            return found
    return None


def opt_state_from_jax(opt_state: Any, params_tree: Mapping[str, Any], lr: float = 1e-2) -> dict:
    """An optax.adam state (the chain tuple holding a ScaleByAdamState with
    count, mu and nu; arrays or anything numpy reads) of a flax
    SoftSDFModel whose parameters are ``params_tree`` -> a
    torch.optim.Adam state_dict for the port's SoftSDFModel, in
    PARAM_NAMES order: step from count, exp_avg from mu, exp_avg_sq from
    nu, and create_train_state's param_groups at ``lr``. Reads only numpy;
    ``load_state_dict`` moves the moments to the parameters' device."""
    found = _adam_moments(opt_state)
    if found is None:
        raise ValueError("opt_state_from_jax: no Adam state (count, mu, nu) in the optax state")
    count, mu, nu = found
    params = params_from_jax(params_tree)
    mu, nu = params_from_jax(mu), params_from_jax(nu)
    groups = _adam([torch.zeros_like(params[k]) for k in PARAM_NAMES], lr).state_dict()["param_groups"]
    state = {
        i: {"step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": mu[k], "exp_avg_sq": nu[k]}
        for i, k in enumerate(PARAM_NAMES)
    }
    return {"state": state, "param_groups": groups}
