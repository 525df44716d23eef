"""hard.entry_host_us: host microseconds a call spends inside the entry
before it returns (the synchronize after it not counted), the mean over the
traced window's calls; the span is the hard loop's own, around the call."""


def read(ctx):
    spans = ctx.spans.get("entry_host_s") or []
    return 1e6 * sum(spans) / len(spans) if spans else None
