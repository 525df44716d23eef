"""hard.launch_host_us: host microseconds a call spends inside the
kernels' launches (``launch.<entry>``: the library's load, the device
guard, the stream lookup and the ctypes call), summed over the traced
window, per call."""

from benchmark.harness import spans


def read(ctx):
    return spans.per_unit(ctx, spans.LAUNCH, (), 1e6)
