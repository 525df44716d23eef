"""The isolation check compares whole top-level module names."""

from benchmark.harness import isolation


def test_the_port_is_not_the_jax_package():
    assert isolation.forbidden(["chaq_sdfgen_tpu_torch", "chaq_sdfgen_tpu_torch.ops.cuda_edt", "torch"]) == []


def test_jax_and_the_jax_package_are_found():
    mods = ["jax.numpy", "jaxlib", "flax.linen", "chaq_sdfgen_tpu.ops.edt", "numpy"]
    assert isolation.forbidden(mods) == ["chaq_sdfgen_tpu", "flax", "jax", "jaxlib"]


def test_names_that_only_begin_alike_pass():
    assert isolation.forbidden(["jaxtyping", "jax_like", "flaxen", "chaq_sdfgen_tpu2"]) == []
