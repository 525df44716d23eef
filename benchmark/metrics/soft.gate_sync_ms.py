"""soft.gate_sync_ms: host milliseconds a step spends blocked in
device-to-host scalar reads (the runtime gate's read of the largest height):
the profiler's own aten::_local_scalar_dense ops (aten::item where the trace
has none), summed over the traced window, per step."""

READS = ("aten::_local_scalar_dense", "aten::item")


def read(ctx):
    if ctx.units == 0:
        return None
    return 1e3 * ctx.trace.host_seconds(READS) / ctx.units
