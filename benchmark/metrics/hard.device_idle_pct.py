"""The share of the traced window in which no operation ran on the card,
in percent."""


def read(ctx):
    idle = ctx.trace.idle_share()
    return None if idle is None or ctx.trace.busy_s <= 0 else 100.0 * idle
