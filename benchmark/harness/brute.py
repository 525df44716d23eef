"""The BRUTE cells' op spans. A BRUTE call's host time splits as an EXACT
call's does (harness/spans.py): the entry (``sdf.atlas``), the op wrappers
(``sdf.threshold``, ``sdf.brute_rows``, ``sdf.brute_scan``) and the launches
(``launch.*``). Its roofline share is ``hard.kernel_roofline_pct``: the bytes
floor (harness/roofline.hard_floor) binds both transforms."""

from __future__ import annotations

from benchmark.harness import spans

OPS = ("sdf.threshold", "sdf.brute_*")
BRUTE_SPANS = ("sdf.brute_*",)


def has_brute_spans(ctx) -> bool:
    """Whether the traced window holds a BRUTE op span: a program without
    them (one whose atlas ran EXACT for any algorithm) reads None."""
    return spans.exclusive_s(ctx.trace, BRUTE_SPANS) is not None


def per_unit(ctx, outer, children=()):
    """spans.per_unit in microseconds a call where the window holds a BRUTE
    op span, else None."""
    return spans.per_unit(ctx, outer, children, 1e6) if has_brute_spans(ctx) else None
