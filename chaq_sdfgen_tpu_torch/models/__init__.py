"""Model layer: config-driven SDF generation pipelines (EXACT so far)."""
