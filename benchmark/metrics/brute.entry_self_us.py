"""brute.entry_self_us: host microseconds a BRUTE call spends in the
entry's own code: inside its span (``sdf.atlas``) and outside every op span
(``sdf.threshold``, ``sdf.brute_*``) and launch span (``launch.*``) on its
thread, summed over the traced window, per call. None where no BRUTE op
span was recorded."""

from benchmark.harness import brute, spans


def read(ctx):
    return brute.per_unit(ctx, spans.HARD_ENTRY, brute.OPS + spans.LAUNCH)
