"""soft.gate_host_ms: host milliseconds a step spends inside the runtime
gate's span (``soft.gate``: the largest height's max, its softplus and the
blocking read to the host), summed over the traced window, per step."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_unit(ctx, ("soft.gate",), (), 1e3)
