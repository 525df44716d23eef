"""The sharded tier: device meshes, halo exchange and the sharded hard
pipelines (chaq_sdfgen_tpu/parallel)."""
