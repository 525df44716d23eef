"""Plain reference of the ``soft_train_s64`` configuration: SoftSDFModel's
training steps written out from the soft field's mathematics, in plain
PyTorch on any device, by default in float64. Independent of the program:
it imports nothing of it and takes nothing it made; the initial parameters
come from the configuration's file.

Front end (parameters bias, log_tau, mix[2]; tau_s the configured tau):
  s = softmax(mix), gray = sum_c x_c s_c - bias,
  v = (gray - 127.5) / exp(log_tau) * tau_s + 127.5
Soft field (T, eps, band = spread + 2):
  l = (v - 127.5) / tau_s, h_in = T softplus(-l), h_out = T softplus(l)
  S1 = softmin along x, d2 = softmin of S1 along y, where
  softmin(h)(p) = -T log sum_{|d| <= band, p + d inside} exp(-(d^2 + h(p + d)) / T)
  d = sqrt(relu(d2) + eps), field = d_out - relu(d_in - 1)
Heights are not clipped: the clip of the program's undeclared path is 1e30,
far above any height here. The soft-min is the exact banded sum: the
program's kernels leave out taps below e^-27 (adaptive) or beyond radius 16
and e^-30 (declared, runtime gate in gamut), each far below float32's
rounding.
Loss: mean of (field - target)^2; its gradient by the chain rule written
out (the soft-min's VJP is its softmax weights), then Adam as
torch.optim.Adam and optax.adam compute it (eps outside the square root).
"""

from __future__ import annotations

import math

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))


def _pad(x: torch.Tensor, band: int, dim: int, value: float) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = band
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([fill, x, fill], dim)


def softmin(h: torch.Tensor, band: int, t: float, dim: int) -> torch.Tensor:
    """-T log sum_{|d| <= band} exp(-(d^2 + h(p + d)) / T) along ``dim``,
    positions outside the tensor being no taps; the hard minimum first,
    so that every exponent is at most 0."""
    n = h.shape[dim]
    hp = _pad(h, band, dim, math.inf)
    m = torch.full_like(h, math.inf)
    for d in range(-band, band + 1):
        m = torch.minimum(m, hp.narrow(dim, band + d, n) + d * d)
    s = torch.zeros_like(h)
    for d in range(-band, band + 1):
        s = s + torch.exp((m - (hp.narrow(dim, band + d, n) + d * d)) / t)
    return m - t * torch.log(s)


def softmin_vjp(ct: torch.Tensor, h: torch.Tensor, out: torch.Tensor, band: int, t: float,
                dim: int) -> torch.Tensor:
    """The cotangent of ``h`` from that of ``out`` = softmin(h): each tap's
    weight exp((out(p) - d^2 - h(p + d)) / T) carries ct(p) to h(p + d)."""
    n = h.shape[dim]
    ctp = _pad(ct, band, dim, 0.0)
    outp = _pad(out, band, dim, -math.inf)
    acc = torch.zeros_like(h)
    for d in range(-band, band + 1):  # p = q - d
        o = outp.narrow(dim, band - d, n)
        acc = acc + ctp.narrow(dim, band - d, n) * torch.exp((o - d * d - h) / t)
    return acc


def field_and_vjp(v: torch.Tensor, target: torch.Tensor, model: dict, n_total: int):
    """(sum of (field - target)^2 / n_total, d loss / d v) for one image."""
    band = int(model["spread"]) + 2
    tau, t, eps = float(model["tau"]), float(model["temperature"]), float(model["eps"])
    l = (v - 127.5) / tau
    grads = []
    fields = []
    for sign in (-1.0, 1.0):  # the inside field's heights, then the outside's
        h = t * softplus(sign * l)
        s1 = softmin(h, band, t, -1)
        d2 = softmin(s1, band, t, -2)
        fields.append((h, s1, d2, torch.sqrt(d2.clamp(min=0) + eps)))
    d_in, d_out = fields[0][3], fields[1][3]
    field = d_out - (d_in - 1.0).clamp(min=0)
    diff = field - target
    loss = (diff * diff).sum() / n_total
    ct = 2.0 * diff / n_total
    ct_v = torch.zeros_like(v)
    for (h, s1, d2, d), ct_d, sign in ((fields[0], -ct * (d_in > 1.0), -1.0), (fields[1], ct, 1.0)):
        ct_d2 = ct_d * 0.5 / d * (d2 > 0)
        ct_h = softmin_vjp(softmin_vjp(ct_d2, s1, d2, band, t, -2), h, s1, band, t, -1)
        # dh/dv = T sigmoid(sign l) sign / tau
        ct_v = ct_v + ct_h * t * torch.sigmoid(sign * l) * sign / tau
    return loss, ct_v


def init_params(model: dict, dtype, device) -> dict:
    init = model["init"]
    log_tau = math.log(float(model["tau"])) if init["log_tau"] == "log(tau)" else float(init["log_tau"])
    as_t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return {"threshold_bias": as_t(float(init["threshold_bias"])), "log_tau": as_t(log_tau),
            "channel_mix": as_t([float(c) for c in init["channel_mix"]])}


def loss_and_grads(params: dict, x: torch.Tensor, target: torch.Tensor, model: dict, dtype):
    """The loss over a (B, H, W, 2) batch and its gradient for each
    parameter, an image at a time."""
    tau_s = float(model["tau"])
    mix = torch.softmax(params["channel_mix"], 0)
    scale = tau_s / torch.exp(params["log_tau"])
    n_total = target.numel()
    loss = torch.zeros((), dtype=dtype, device=x.device)
    g_bias = torch.zeros_like(loss)
    g_tau = torch.zeros_like(loss)
    g_mix = torch.zeros_like(params["channel_mix"])
    for i in range(x.shape[0]):
        xi = x[i].to(dtype)
        mixed = (xi * mix).sum(-1)
        v = (mixed - params["threshold_bias"] - 127.5) * scale + 127.5
        li, ct_v = field_and_vjp(v, target[i].to(dtype), model, n_total)
        loss = loss + li
        g_bias = g_bias - (ct_v * scale).sum()
        g_tau = g_tau - (ct_v * (v - 127.5)).sum()
        # d mixed / d mix_j = s_j (x_j - mixed)
        g_mix = g_mix + torch.stack([(ct_v * scale * mix[j] * (xi[..., j] - mixed)).sum() for j in range(2)])
    return loss, {"threshold_bias": g_bias, "log_tau": g_tau, "channel_mix": g_mix}


def train(batches, targets, config: dict, dtype=torch.float64) -> dict:
    """Adam steps from the configuration's initial parameters, one a batch:
    {"loss": [each step's loss], "grad": {leaf: norm of the first step's
    gradient}, "change": {leaf: norm of the parameters' change over the
    steps}}, as Python floats."""
    model, opt = config["model"], config["optimizer"]
    lr, b1, b2, eps = (float(opt[k]) for k in ("lr", "b1", "b2", "eps"))
    params = init_params(model, dtype, batches[0].device)
    start = {k: p.clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for step, (x, target) in enumerate(zip(batches, targets), 1):
        loss, grads = loss_and_grads(params, x, target, model, dtype)
        losses.append(float(loss))
        if first is None:
            first = {k: float(g.double().norm()) for k, g in grads.items()}
        for k in params:
            m[k] = b1 * m[k] + (1 - b1) * grads[k]
            v[k] = b2 * v[k] + (1 - b2) * grads[k] * grads[k]
            m_hat = m[k] / (1 - b1 ** step)
            v_hat = v[k] / (1 - b2 ** step)
            params[k] = params[k] - lr * m_hat / (torch.sqrt(v_hat) + eps)
    change = {k: float((params[k] - start[k]).double().norm()) for k in params}
    return {"loss": losses, "grad": first, "change": change}
