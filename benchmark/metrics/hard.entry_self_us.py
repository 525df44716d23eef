"""hard.entry_self_us: host microseconds a call spends in the entry's own
code: inside its span (``sdf.atlas``, ``sdf.generate``) and outside every
op span (``sdf.threshold``, ``sdf.edt_*``) and launch span (``launch.*``)
on its thread, summed over the traced window, per call."""

from benchmark.harness import spans


def read(ctx):
    whole = spans.per_unit(ctx, spans.HARD_ENTRY, (), 1e6)
    if whole is not None:
        ctx.log(f"hard.entry_self_us: the entry's spans {whole:.3f} us a call in all")
    return spans.per_unit(ctx, spans.HARD_ENTRY, spans.HARD_OPS + spans.LAUNCH, 1e6)
