"""hard.kernel_roofline_pct: the least time the EXACT transform of a call's
pixels needs on the card (harness/roofline.hard_floor: its bytes at the
memory rate or pass 2's operations at the float32 rate, the larger) over
the device time a call took, every device operation of the traced window
summed, per call. No kernel name enters it."""

from benchmark.harness import roofline


def read(ctx):
    if ctx.units == 0 or ctx.trace.device_s <= 0:
        return None
    floor_s, bound = roofline.hard_floor(ctx.pixels_per_unit)
    per_call = ctx.trace.device_s / ctx.units
    ctx.log(f"hard.kernel_roofline_pct: floor {floor_s * 1e3:.6f} ms a call ({bound}), "
            f"device {per_call * 1e3:.6f} ms a call")
    return roofline.share_pct(floor_s, per_call)
