"""Model layer: config-driven SDF generation pipelines (EXACT, BRUTE, JFA
and the soft field), the batched glyph atlas, the trainable soft model and
its checkpoints."""
