"""chaq_sdfgen_tpu_torch -- the PyTorch and CUDA port of chaq_sdfgen_tpu.

The hard EXACT pipeline (OpenMP-binary parity) runs on an NVIDIA Hopper
card through two hand-written CUDA kernels (csrc/edt.cu), the exact
full-range distance field through a third; the BRUTE pipeline
(OpenCL-binary parity) through two more (csrc/brute.cu); the jump flood
(JFA) as torch ops, as in the JAX package; the
differentiable soft field, forward and backward, through two more on a
declared gray range (csrc/soft_mm.cu; wider taps as float32 matrix
products), behind a runtime gate four adaptive ones for any range
(csrc/soft_fused.cu), and above band 112 or on one row the composed path's
column soft-min pair (csrc/softmin.cu); and the trainable SoftSDFModel on
top. parallel/ runs the hard algorithms and the soft field over a device
mesh, with halo kernels (csrc/halo.cu) and the sharded soft tier's
cols-conv kernels (csrc/band_conv.cu). Plain PyTorch versions beside the
kernels serve CPU tensors. This package imports no JAX; the JAX package beside it is
the reference it is tested against.
"""

from chaq_sdfgen_tpu_torch.config import Algorithm, Channel, SdfConfig, ShardingConfig, SoftConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import (
    SDFGenerator,
    hard_sdf_brute,
    hard_sdf_exact,
    hard_sdf_exact_from_bool,
    hard_sdf_jfa,
    signed_distance_field_exact,
)
from chaq_sdfgen_tpu_torch.models.soft_model import (
    SoftSDFModel,
    create_train_state,
    make_train_step,
    params_from_jax,
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
    "SoftSDFModel",
    "create_train_state",
    "hard_sdf_brute",
    "hard_sdf_exact",
    "hard_sdf_exact_from_bool",
    "hard_sdf_jfa",
    "make_train_step",
    "params_from_jax",
    "signed_distance_field_exact",
    "soft_remap",
    "soft_sdf_bytes",
    "soft_sdf_field",
    "__version__",
]
