"""Driver of the atlas cells: chaq_sdfgen_tpu_torch.models.atlas.atlas_sdf on
a (N, H, W, 2) stack a call, the configuration's SdfConfig, one card."""

from benchmark.harness.hardloop import HardLoop


def make(run):
    def entry():
        from chaq_sdfgen_tpu_torch import SdfConfig
        from chaq_sdfgen_tpu_torch.models.atlas import atlas_sdf

        cfg = SdfConfig(**run.config["sdf_config"])
        return lambda x: atlas_sdf(x, cfg, device=run.device)

    return HardLoop(run, entry)
