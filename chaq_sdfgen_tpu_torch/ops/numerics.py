"""Numerics helpers for bit-exact parity (chaq_sdfgen_tpu/ops/numerics.py).

``torch.sqrt`` on the CPU is not correctly rounded: it differs by one ulp
from the IEEE float32 result on about 105 thousand of the 2^24 integer
radicands (the first is 267). ``refined_sqrt`` recovers the correctly
rounded root with one Newton step in double-float32 through a Veltkamp
split, op for op as the JAX function, so both return the same bits on
every integer below 2^24. Each torch op rounds on its own, so no multiply
and add are contracted into an FMA, which would break the split.
"""

from __future__ import annotations

import torch


def refined_sqrt(n: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt of exactly-representable non-negative
    float32 values (integers < 2^24 in our use)."""
    n = n.to(torch.float32)
    s0 = torch.sqrt(n)
    c = s0 * 4097.0
    hi = c - (c - s0)
    lo = s0 - hi
    # exact expansion of n - s0*s0
    e = ((n - hi * hi) - (2.0 * hi) * lo) - lo * lo
    # guard against s0 == 0 (n == 0): correction is 0/0 -> force 0
    denom = 2.0 * s0
    one = torch.ones((), dtype=torch.float32, device=n.device)
    zero = torch.zeros((), dtype=torch.float32, device=n.device)
    corr = torch.where(n > 0, e / torch.where(denom > 0, denom, one), zero)
    return torch.where(n > 0, s0 + corr, zero)
