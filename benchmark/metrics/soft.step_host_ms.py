"""soft.step_host_ms: host milliseconds a step spends on its calling thread
inside the training step's span (``soft.step``) and outside the gate's
(``soft.gate``): the host's own work a step, its wait for the backward
included, summed over the traced window, per step. As it nears
soft_step_ms, the host sets the pace."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_unit(ctx, ("soft.step",), ("soft.gate",), 1e3)
