"""chaq_sdfgen_tpu_torch -- the PyTorch and CUDA port of chaq_sdfgen_tpu.

The hard EXACT pipeline (OpenMP-binary parity) runs on an NVIDIA Hopper
card through two hand-written CUDA kernels (csrc/edt.cu), and the
differentiable soft field on a declared gray range, forward and backward,
through two more (csrc/soft_mm.cu), with plain PyTorch versions beside them
for CPU tensors. This package imports no JAX; the JAX package beside it is
the reference it is tested against.
"""

from chaq_sdfgen_tpu_torch.config import Algorithm, Channel, SdfConfig, ShardingConfig, SoftConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import (
    SDFGenerator,
    hard_sdf_exact,
    hard_sdf_exact_from_bool,
)
from chaq_sdfgen_tpu_torch.ops.merge import soft_remap
from chaq_sdfgen_tpu_torch.ops.softsdf import soft_sdf_bytes, soft_sdf_field

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Channel",
    "SdfConfig",
    "ShardingConfig",
    "SoftConfig",
    "SDFGenerator",
    "hard_sdf_exact",
    "hard_sdf_exact_from_bool",
    "soft_remap",
    "soft_sdf_bytes",
    "soft_sdf_field",
    "__version__",
]
