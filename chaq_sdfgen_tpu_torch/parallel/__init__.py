"""The sharded tier: device meshes, halo exchange, the sharded hard and
soft pipelines, and the batched tier's mesh and startup checks
(chaq_sdfgen_tpu/parallel)."""
