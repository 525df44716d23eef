"""hard.ops_self_us: host microseconds a call spends in the op wrappers'
own code: inside the op spans (``sdf.threshold``, ``sdf.edt_rows``,
``sdf.edt_band``) and outside the launch spans (``launch.*``) on their
thread, summed over the traced window, per call."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_unit(ctx, spans.HARD_OPS, spans.LAUNCH, 1e6)
