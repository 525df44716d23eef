"""soft.kernel_roofline_pct: the least time a training step's bytes need on
the card (harness/roofline.soft_step_floor: the float32 input and target,
each read once, at the memory rate) over the device time a step took, every
device operation of the traced window summed, per step."""

from benchmark.harness import roofline


def read(ctx):
    if ctx.units == 0 or ctx.trace.device_s <= 0:
        return None
    floor_s, bound = roofline.soft_step_floor(ctx.pixels_per_unit)
    per_step = ctx.trace.device_s / ctx.units
    ctx.log(f"soft.kernel_roofline_pct: floor {floor_s * 1e3:.6f} ms a step ({bound}), "
            f"device {per_step * 1e3:.6f} ms a step")
    return roofline.share_pct(floor_s, per_step)
