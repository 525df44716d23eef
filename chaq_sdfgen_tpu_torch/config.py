"""Frozen configuration, field for field the JAX package's
(chaq_sdfgen_tpu/config.py), as plain dataclasses that import no JAX.

The hard EXACT pipeline has no learned weights: the configuration is the
only state carried from the JAX package to this one
(``SdfConfig.from_dict(dataclasses.asdict(jax_cfg))``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Mapping, Optional, Tuple


class Algorithm(str, enum.Enum):
    """Which distance-transform core to run. Only EXACT (the banded
    separable exact EDT, byte-identical to the OpenMP reference binary) is
    ported so far; BRUTE and JFA are ROADMAP Queue 1 items 7 and 8."""

    EXACT = "exact"
    BRUTE = "brute"
    JFA = "jfa"


class Channel(str, enum.Enum):
    """Which channel the threshold tests (openmp/sdfgen.c:264, -l flag)."""

    ALPHA = "alpha"          # default: byte offset 1 of the gray+alpha pair
    LUMINANCE = "luminance"  # -l flag: byte offset 0


@dataclasses.dataclass(frozen=True)
class SdfConfig:
    """Reference defaults: spread 64, alpha channel, symmetric, not
    inverted (openmp/sdfgen.c:128-133)."""

    spread: int = 64
    asymmetric: bool = False
    channel: Channel = Channel.ALPHA
    invert: bool = False
    algorithm: Algorithm = Algorithm.EXACT
    jfa_plus_one: bool = True  # run the extra +1 pass (1+JFA accuracy fix)
    band: Optional[int] = None  # banded-EDT half-width; default spread + 2

    def __post_init__(self):
        if self.spread < 1:
            raise ValueError("spread must be a positive integer")
        if isinstance(self.channel, str):
            object.__setattr__(self, "channel", Channel(self.channel))
        if isinstance(self.algorithm, str):
            object.__setattr__(self, "algorithm", Algorithm(self.algorithm))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "SdfConfig":
        """Build from ``dataclasses.asdict`` of a JAX ``SdfConfig`` (enum
        members or their string values are both accepted)."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown SdfConfig fields: {sorted(unknown)}")
        kw = dict(d)
        for key, enum_cls in (("channel", Channel), ("algorithm", Algorithm)):
            if key in kw:
                kw[key] = enum_cls(getattr(kw[key], "value", kw[key]))
        return cls(**kw)

    @property
    def channel_offset(self) -> int:
        return 0 if self.channel == Channel.LUMINANCE else 1

    @property
    def effective_band(self) -> int:
        """Half-width of the exact band. band >= spread + 2 guarantees that
        every distance that survives the clamped remap (including the -1
        inside bias, openmp/sdfgen.c:103) is computed exactly; anything
        farther saturates above the clamp."""
        return self.band if self.band is not None else self.spread + 2


@dataclasses.dataclass(frozen=True)
class SoftConfig:
    """Differentiable-path configuration (same fields and defaults as the
    JAX package's). The soft path is not ported yet (ROADMAP Queue 1
    item 5); the dataclass exists so configurations carry across."""

    tau: float = 1.0
    temperature: float = 0.5
    eps: float = 1e-6
    clamp: str = "hard"
    gray_range: Optional[Tuple[float, float]] = (0.0, 255.0)


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Device-mesh layout (same fields, defaults and validation as the JAX
    package's). Building a mesh waits for the multi-GPU tier (ROADMAP
    Queue 1 item 11)."""

    mesh_shape: Tuple[int, ...] = (1,)
    axis_names: Tuple[str, ...] = ("y",)
    data_axis: Optional[str] = None
    halo_impl: str = "ppermute"

    def __post_init__(self):
        if len(self.mesh_shape) != len(self.axis_names):
            raise ValueError(
                f"mesh_shape {self.mesh_shape} and axis_names "
                f"{self.axis_names} must have equal length"
            )
        if self.halo_impl not in ("ppermute", "rdma"):
            raise ValueError(f"unknown halo_impl {self.halo_impl!r}")
        if self.data_axis is not None and self.data_axis not in self.axis_names:
            raise ValueError(
                f"data_axis {self.data_axis!r} not in axis_names {self.axis_names}"
            )

    @property
    def y_axis(self) -> str:
        for n in self.axis_names:
            if n != self.data_axis:
                return n
        raise ValueError("ShardingConfig has no image axis")

    @property
    def x_axis(self) -> Optional[str]:
        img_axes = [n for n in self.axis_names if n != self.data_axis]
        if len(img_axes) >= 2:
            ext = dict(zip(self.axis_names, self.mesh_shape))[img_axes[1]]
            if ext > 1:
                return img_axes[1]
        return None

    def build_mesh(self):
        raise NotImplementedError(
            "multi-GPU sharding is not ported yet (ROADMAP Queue 1 item 11)"
        )
