"""brute.ops_self_us: host microseconds a BRUTE call spends in the op
wrappers' own code: inside the op spans (``sdf.threshold``,
``sdf.brute_rows``, ``sdf.brute_scan``) and outside the launch spans
(``launch.*``) on their thread, summed over the traced window, per call.
None where no BRUTE op span was recorded."""

from benchmark.harness import brute, spans


def read(ctx):
    return brute.per_unit(ctx, brute.OPS, spans.LAUNCH)
