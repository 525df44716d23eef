"""Driver of the one-image cells: chaq_sdfgen_tpu_torch.SDFGenerator(config)
built in set-up, ``generate`` on one (H, W, 2) image a call."""

from benchmark.harness.hardloop import HardLoop


def make(run):
    def entry():
        from chaq_sdfgen_tpu_torch import SDFGenerator, SdfConfig

        return SDFGenerator(SdfConfig(**run.config["sdf_config"]), device=run.device).generate

    return HardLoop(run, entry, single=int(run.traffic["images_per_call"]) == 1)
