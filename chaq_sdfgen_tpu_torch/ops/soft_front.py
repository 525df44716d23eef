"""The soft training step's elementwise front end and MSE loss
(models/soft_model.py) as two autograd Functions over the kernels of
csrc/soft_front.cu, each kernel beside its plain PyTorch version. They
replace no Pallas kernel: the JAX package leaves both chains to XLA.

  front_end  (..., 2) img2ch and the parameters -> v (...):
             g = img2ch . mix - bias, v = (g - 127.5) / tau * tau_s + 127.5,
             with mix = softmax(channel_mix) and tau = exp(log_tau), tensors
             the kernels read by pointer (kernels ``soft_front_fwd``,
             ``soft_front_bwd``);
  mse        sum((pred - target)^2) / n, n the element count (the mean) or,
             for one process's part of a batch spread over processes, the
             global one (kernels ``soft_mse_fwd``, ``soft_mse_bwd``).

The forward's v is bitwise the chain ``(img2ch * mix).sum(-1) - bias``,
``(g - 127.5) / tau * tau_s + 127.5`` on either device (the plain forward
is that chain). The backward forms the gradient at g as the chain rounds
it, dg = fl(fl(dv tau_s) / tau), the pixels' gradient fl(dg mix_k) as the
chain's, and the parameters' from four sums over the pixels taken in
float64 (sum dg, sum dg (g - 127.5), sum dg x0, sum dg x1); the loss sums
its squares in float64 too, and its backward is the chain's
fl(fl(g fl(1/n)) 2 (pred - target)). softmax and exp stay torch ops
outside the Functions, so autograd carries d mix and d tau on to the
parameters.

A wrapper runs the plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises; it never falls back. ``LAUNCHES``
counts kernel launches, one per launch.
"""

from __future__ import annotations

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.ops import _build

LAUNCHES = {"soft_front_fwd": 0, "soft_front_bwd": 0, "soft_mse_fwd": 0, "soft_mse_bwd": 0}

REDUCE_BLOCKS = 1024  # kReduceBlocks of csrc/soft_front.cu: the partials a reduction writes


def _check(name, x, *rest):
    """x (..., C) and the tensors of ``rest``: one CUDA device, float32,
    contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for t in (x, *rest):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _check_pair(name, pred, target):
    _check(name, pred, target)
    if target.shape != pred.shape:
        raise ValueError(f"{name}: target {tuple(target.shape)} for pred {tuple(pred.shape)}")


def _check_front(name, img2ch, mix, bias, tau):
    _check(name, img2ch, mix, bias, tau)
    if img2ch.dim() < 1 or img2ch.shape[-1] != 2:
        raise ValueError(f"{name}: expected (..., 2) pixels, got shape {tuple(img2ch.shape)}")
    if mix.numel() != 2 or bias.numel() != 1 or tau.numel() != 1:
        raise ValueError(f"{name}: expected 2 mix weights, one bias and one tau, got "
                         f"{mix.numel()}, {bias.numel()}, {tau.numel()}")


# ---------------------------------------------------------------- front end


def front_fwd_plain(img2ch, mix, bias, tau, tau_s):
    """The chain itself, on any device."""
    gray = (img2ch * mix).sum(-1) - bias
    return (gray - 127.5) / tau * tau_s + 127.5


def front_fwd(img2ch, mix, bias, tau, tau_s):
    """(..., 2) float32 img2ch -> v (...), bitwise front_fwd_plain. Kernel
    ``soft_front_fwd`` on CUDA, the plain version on the CPU."""
    if img2ch.device.type == "cpu":
        return front_fwd_plain(img2ch, mix, bias, tau, tau_s)
    _check_front("front_fwd", img2ch, mix, bias, tau)
    v = img2ch.new_empty(img2ch.shape[:-1])
    if v.numel() > 0:
        _build.launch("chaq_soft_front_fwd", img2ch.device, img2ch.data_ptr(), v.data_ptr(), mix.data_ptr(),
                      bias.data_ptr(), tau.data_ptr(), float(tau_s), v.numel())
        LAUNCHES["soft_front_fwd"] += 1
    return v


def front_bwd_plain(dv, img2ch, mix, bias, tau, tau_s, pixels=False):
    """(grads, dimg2ch): grads the (4,) float32 [d mix0, d mix1, d bias,
    d tau], dimg2ch img2ch's gradient with ``pixels``, else None."""
    dg = (dv * tau_s) / tau
    x = ((img2ch * mix).sum(-1) - bias - 127.5).double()
    d = dg.double()
    sums = torch.stack([(d * img2ch[..., 0].double()).sum(), (d * img2ch[..., 1].double()).sum(), -d.sum(),
                        -(d * x).sum() / tau.double().reshape(())])
    return sums.to(torch.float32), (dg[..., None] * mix if pixels else None)


def front_bwd(dv, img2ch, mix, bias, tau, tau_s, pixels=False):
    """front_bwd_plain's (grads, dimg2ch) from v's float32 cotangent dv
    (...) and the forward's inputs: kernel ``soft_front_bwd`` on CUDA (the
    block partials and one block that sums them, in one launch), the plain
    version on the CPU."""
    if dv.device.type == "cpu":
        return front_bwd_plain(dv, img2ch, mix, bias, tau, tau_s, pixels)
    _check_front("front_bwd", img2ch, mix, bias, tau)
    _check("front_bwd", dv)
    if dv.shape != img2ch.shape[:-1]:
        raise ValueError(f"front_bwd: cotangent {tuple(dv.shape)} for pixels {tuple(img2ch.shape)}")
    grads = dv.new_empty(4)
    dimg = torch.empty_like(img2ch) if pixels else None
    partials = torch.empty(REDUCE_BLOCKS * 4, dtype=torch.float64, device=dv.device)
    _build.launch("chaq_soft_front_bwd", dv.device, dv.data_ptr(), img2ch.data_ptr(),
                  None if dimg is None else dimg.data_ptr(), partials.data_ptr(), grads.data_ptr(),
                  mix.data_ptr(), bias.data_ptr(), tau.data_ptr(), float(tau_s), dv.numel())
    LAUNCHES["soft_front_bwd"] += 1
    return grads, dimg


class _FrontEnd(torch.autograd.Function):
    """v from img2ch and the parameters' tensors; the backward writes
    img2ch's gradient only where img2ch needs one."""

    @staticmethod
    def forward(ctx, img2ch, mix, bias, tau, tau_s):
        ctx.save_for_backward(img2ch, mix, bias, tau)
        ctx.tau_s = tau_s
        return front_fwd(img2ch, mix, bias, tau, tau_s)

    @staticmethod
    def backward(ctx, dv):
        img2ch, mix, bias, tau = ctx.saved_tensors
        grads, dimg = front_bwd(dv.to(torch.float32).contiguous(), img2ch, mix, bias, tau, ctx.tau_s,
                                pixels=ctx.needs_input_grad[0])
        return dimg, grads[0:2].view_as(mix), grads[2:3].view_as(bias), grads[3:4].view_as(tau), None


def front_end(img2ch, mix, bias, tau, tau_s):
    """v = ((img2ch . mix - bias) - 127.5) / tau * tau_s + 127.5 over the
    last axis of (..., 2) img2ch (made float32 and contiguous), with the (2,)
    ``mix`` and the one-element ``bias`` and ``tau`` tensors on its device,
    differentiable with respect to all four."""
    return _FrontEnd.apply(img2ch.to(torch.float32).contiguous(), mix, bias, tau, float(tau_s))


# --------------------------------------------------------------------- loss


def _inv(n: int) -> float:
    """The float32 reciprocal of n that the chain's mean backward multiplies by."""
    return float(np.float32(1.0) / np.float32(n))


def mse_fwd_plain(pred, target, n):
    return ((pred - target).double().square().sum() / n).to(torch.float32)


def mse_fwd(pred, target, n):
    """sum((pred - target)^2) / n, a 0-d float32 tensor, the squares of
    float32 differences summed in float64: kernel ``soft_mse_fwd`` on CUDA
    (partials and their sum in one launch), the plain version on the CPU."""
    if pred.device.type == "cpu":
        return mse_fwd_plain(pred, target, n)
    _check_pair("mse_fwd", pred, target)
    loss = pred.new_empty(())
    partials = torch.empty(REDUCE_BLOCKS, dtype=torch.float64, device=pred.device)
    _build.launch("chaq_soft_mse_fwd", pred.device, pred.data_ptr(), target.data_ptr(), partials.data_ptr(),
                  loss.data_ptr(), pred.numel(), float(n))
    LAUNCHES["soft_mse_fwd"] += 1
    return loss


def mse_bwd_plain(pred, target, g, n):
    return (g * _inv(n)) * (2.0 * (pred - target))


def mse_bwd(pred, target, g, n):
    """pred's gradient from the loss's 0-d float32 cotangent g: kernel
    ``soft_mse_bwd`` on CUDA (g read by pointer), the plain version on the
    CPU."""
    if pred.device.type == "cpu":
        return mse_bwd_plain(pred, target, g, n)
    _check_pair("mse_bwd", pred, target)
    _check("mse_bwd", pred, g)
    dpred = torch.empty_like(pred)
    if pred.numel() > 0:
        _build.launch("chaq_soft_mse_bwd", pred.device, pred.data_ptr(), target.data_ptr(), g.data_ptr(),
                      dpred.data_ptr(), pred.numel(), _inv(n))
        LAUNCHES["soft_mse_bwd"] += 1
    return dpred


class _Mse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, n):
        ctx.save_for_backward(pred, target)
        ctx.n = n
        return mse_fwd(pred, target, n)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        dpred = mse_bwd(pred, target, g.to(torch.float32).contiguous(), ctx.n)
        return dpred, None, None


def mse(pred, target, n):
    """sum((pred - target)^2) / n over pred's elements, ``target`` of
    pred's shape, both made float32 and contiguous: the mean where n is
    pred.numel(). Differentiable with respect to pred."""
    if target.shape != pred.shape:
        raise ValueError(f"mse: target {tuple(target.shape)} for pred {tuple(pred.shape)}")
    return _Mse.apply(pred.to(torch.float32).contiguous(), target.to(torch.float32).contiguous(), int(n))
