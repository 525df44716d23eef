"""Checkpoint and resume of soft-model training state, and .npy dumps of
intermediate grids (chaq_sdfgen_tpu/models/checkpoint.py).

Orbax and its tree-structure sidecar become one ``torch.save`` of
``{"params": model.state_dict(), "opt_state": optimizer.state_dict(),
"step": int}``, read back with ``weights_only=True`` onto the CPU, so that
a state saved on a card restores anywhere; ``load_state_dict`` moves it
to the model's device. A JAX train state comes over through
soft_model.params_from_jax and soft_model.opt_state_from_jax.
"""

from __future__ import annotations

import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch

KEYS = ("params", "opt_state", "step")


def _state_dict(x: Any) -> Any:
    """A module's or an optimizer's state_dict; a state_dict as it is."""
    return x.state_dict() if hasattr(x, "state_dict") else x


def save_train_state(path: str, params: Any, opt_state: Any, step: int) -> None:
    """Write (params, opt_state, step) to ``path`` in one file. params and
    opt_state: state_dicts, or the model and the optimizer themselves."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"params": _state_dict(params), "opt_state": _state_dict(opt_state), "step": int(step)}, path)


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of a nested dict / list / tuple, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _spec(tree: Any) -> dict:
    """Each leaf's path with its shape and dtype (tensors) or its type
    (anything else)."""
    return {path: (tuple(leaf.shape), leaf.dtype) if isinstance(leaf, torch.Tensor) else type(leaf).__name__
            for path, leaf in _leaves(tree)}


def _check_like(name: str, got: Any, like: Any) -> None:
    like = _state_dict(like)
    if name == "opt_state" and like.get("state") == {}:
        # an optimizer before its first step holds no per-parameter state
        got = {k: v for k, v in got.items() if k != "state"}
    want, have = _spec(like), _spec(got)
    if want.keys() != have.keys():
        raise ValueError(f"restored {name} differ from the template in names: missing "
                         f"{sorted(want.keys() - have.keys())}, unexpected {sorted(have.keys() - want.keys())}")
    bad = [f"{k}: {have[k]} != {want[k]}" for k in want
           if isinstance(want[k], tuple) and have[k] != want[k]]
    if bad:
        raise ValueError(f"restored {name} differ from the template in shape or dtype: {'; '.join(bad)}")


def restore_train_state(path: str, like_params: Any = None, like_opt: Any = None):
    """Read (params, opt_state, step) back, tensors on the CPU. ``like_*``
    (state_dicts, or the model and the optimizer) are templates: names,
    shapes and dtypes must match them, else ValueError (an optimizer that
    has not stepped yet checks its param_groups alone). A file that is not
    a train state raises ValueError."""
    path = os.path.abspath(path)
    state = torch.load(path, weights_only=True, map_location="cpu")
    if not isinstance(state, dict) or not set(KEYS) <= set(state):
        raise ValueError(
            f"checkpoint at {path} is not a train state "
            f"(keys: {sorted(state, key=str) if isinstance(state, dict) else type(state)})"
        )
    if like_params is not None:
        _check_like("params", state["params"], like_params)
    if like_opt is not None:
        _check_like("opt_state", state["opt_state"], like_opt)
    return state["params"], state["opt_state"], int(state["step"])


def dump_grid(path: str, name: str, arr) -> str:
    """Save an intermediate field (indicator, row distances, EDT, signed
    values; a tensor on any device or an array) as ``path/name.npy`` for
    offline inspection; returns the file's path."""
    os.makedirs(path, exist_ok=True)
    fp = os.path.join(path, f"{name}.npy")
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    np.save(fp, np.asarray(arr))
    return fp
