"""The soft training step's front end and loss (ops/soft_front.py) on the
CPU: the autograd Functions' plain versions against the torch chain they
replace (models/soft_model.py's ``(img2ch * mix).sum(-1) - bias``, ``(g -
127.5) / tau * tau_s + 127.5`` and ``torch.mean((pred - target) ** 2)``)
evaluated in float64: v (and bitwise against the chain in float32), the
loss, the three parameters' gradients and the pixels' gradient. A gap is
taken as the benchmark's training cells take it:
relative to the larger of the leaf's norm and the median leaf's. The
shapes have odd widths and sides that are no multiple of the kernels'
16-byte vectors; the kernels themselves are held against the chain on the
card (tests/test_torch_cuda_kernels.py)."""

import math
import os

import numpy as np
import pytest
import torch

from chaq_sdfgen_tpu_torch.config import SoftConfig
from chaq_sdfgen_tpu_torch.models import soft_model as tsm
from chaq_sdfgen_tpu_torch.ops import soft_front

SHAPES = [(13, 17), (1, 19, 23), (2, 11, 33)]
TAU_S = 2.0
LEAVES = ("channel_mix", "threshold_bias", "log_tau")


def _img2ch(shape, kind, seed):
    """(..., 2) float32 gray and alpha in [0, 255] ("u8") or mapped to
    (x - 127.5) x 16 ("pm2040"), the training cells' two ranges."""
    x = np.random.default_rng(seed).random(shape + (2,)) * 255
    return torch.from_numpy((x if kind == "u8" else (x - 127.5) * 16).astype(np.float32))


def _leaves(dtype=torch.float32):
    vals = {"channel_mix": [0.3, 1.7], "threshold_bias": 2.5, "log_tau": math.log(TAU_S) + 0.1}
    return {k: torch.tensor(v, dtype=torch.float64).to(dtype).requires_grad_() for k, v in vals.items()}


def _chain(img2ch, p):
    """The torch chain of SoftSDFModel.forward's front end, in the dtype of
    its inputs."""
    mix = torch.softmax(p["channel_mix"], dim=0)
    gray = (img2ch * mix).sum(-1) - p["threshold_bias"]
    return (gray - 127.5) / torch.exp(p["log_tau"]) * TAU_S + 127.5


def _front(img2ch, p):
    return soft_front.front_end(img2ch, torch.softmax(p["channel_mix"], dim=0), p["threshold_bias"],
                                torch.exp(p["log_tau"]), TAU_S)


def _pred(v):
    """A field of v that crosses the target's range (-16, 16) in both cells'
    ranges, so that the cotangents take both signs."""
    return (v - 127.5) / 64.0


def _target(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(-16, 16, shape).astype(np.float32))


def _gaps(got: dict, want: dict) -> dict:
    norms = sorted(float(w.norm()) for w in want.values())
    median = norms[len(norms) // 2]
    return {k: float((got[k].double() - want[k]).norm()) / max(float(want[k].norm()), median) for k in want}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["u8", "pm2040"])
@pytest.mark.parametrize("pixels", [False, True])
def test_front_end_and_loss_match_the_chain_in_float64(shape, kind, pixels):
    img = _img2ch(shape, kind, len(shape))
    target = _target(shape, 7)
    x = img.clone().requires_grad_(pixels)
    p = _leaves()
    v = _front(x, p)
    assert torch.equal(v, _chain(img, _leaves())), "v is not bitwise the float32 chain"
    loss = soft_front.mse(_pred(v), target, target.numel())
    loss.backward()

    x64 = img.double().requires_grad_(pixels)
    p64 = _leaves(torch.float64)
    v64 = _chain(x64, p64)
    loss64 = torch.mean((_pred(v64) - target.double()) ** 2)
    loss64.backward()
    assert float((v.detach().double() - v64.detach()).abs().max()) <= 1e-6 * float(v64.detach().abs().max())
    assert abs(float(loss.detach()) - float(loss64.detach())) <= 1e-6 * float(loss64.detach())
    gaps = _gaps({k: p[k].grad for k in LEAVES}, {k: p64[k].grad for k in LEAVES})
    # the float32 chain itself reads up to 8.3e-6 on channel_mix here (these
    # read 2.4e-6): softmax's backward cancels the two mix gradients' common part
    assert max(gaps.values()) < 1e-5, gaps
    if pixels:
        assert float((x.grad.double() - x64.grad).abs().max()) <= 1e-6 * float(x64.grad.abs().max())
    else:
        assert x.grad is None


@pytest.mark.parametrize("shape", SHAPES)
def test_front_end_takes_the_chain_gradients_of_its_inputs(shape):
    """The Function's own gradients (mix, bias, tau as leaves) against
    autograd through the float32 chain: within 1e-6 of their size; the
    pixels' gradient bitwise."""
    img = _img2ch(shape, "u8", 3)
    dv = _target(shape, 4)
    ins = [torch.tensor(v).requires_grad_() for v in ([0.25, 0.75], 1.5, 2.2)]
    ins_c = [t.detach().clone().requires_grad_() for t in ins]
    x, x_c = img.clone().requires_grad_(), img.clone().requires_grad_()
    soft_front.front_end(x, *ins, TAU_S).backward(dv)
    gray = (x_c * ins_c[0]).sum(-1) - ins_c[1]
    ((gray - 127.5) / ins_c[2] * TAU_S + 127.5).backward(dv)
    for a, b in zip(ins, ins_c):
        assert float((a.grad - b.grad).abs().max()) <= 1e-6 * float(b.grad.abs().max())
    assert torch.equal(x.grad, x_c.grad)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("parts", [1, 3])
def test_mse_divisor_over_processes(shape, parts):
    """One process's part of a batch: its sum of squares over the global
    element count, and the parts' losses and gradients add up to the whole
    batch's mean."""
    pred = _target(shape, 1).requires_grad_()
    target = _target(shape, 2)
    rows = np.array_split(np.arange(shape[-2]), parts)
    total = 0.0
    for r in rows:
        sl = (..., slice(int(r[0]), int(r[-1]) + 1), slice(None))
        part = soft_front.mse(pred[sl], target[sl], target.numel())
        want = float(((pred[sl].detach().double() - target[sl].double()) ** 2).sum()) / target.numel()
        assert abs(float(part.detach()) - want) <= 1e-7 * want
        part.backward()
        total += float(part.detach())
    full = float(((pred.detach().double() - target.double()) ** 2).mean())
    assert abs(total - full) <= 1e-6 * full
    want = 2.0 * (pred.detach().double() - target.double()) / target.numel()
    assert float((pred.grad.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_mse_grad_is_the_chain_mean_backward_bitwise():
    pred = _target((2, 9, 13), 5).requires_grad_()
    target = _target((2, 9, 13), 6)
    pred_c = pred.detach().clone().requires_grad_()
    soft_front.mse(pred, target, target.numel()).backward()
    torch.mean((pred_c - target) ** 2).backward()
    assert torch.equal(pred.grad, pred_c.grad)


@pytest.mark.parametrize("shape", [(5, 7), (1, 5, 7), (3, 5, 6)])
def test_mse_refuses_a_target_of_another_shape(shape):
    """The kernels read as many target elements as pred has: a target of
    another shape is refused, never broadcast."""
    pred = _target((3, 5, 7), 8)
    with pytest.raises(ValueError, match="target"):
        soft_front.mse(pred, _target(shape, 9), pred.numel())


def test_reduce_blocks_is_the_kernels_capacity():
    """The partials the wrappers allocate hold as many blocks as the CUDA
    file's reductions write."""
    with open(os.path.join(soft_front._build.CSRC_DIR, "soft_front.cu")) as f:
        src = f.read()
    assert f"constexpr int kReduceBlocks = {soft_front.REDUCE_BLOCKS};" in src


def test_front_end_takes_other_dtypes_and_strides():
    """uint8 pixels and a strided view are made float32 and contiguous first:
    the same v as the chain on the float32 copy."""
    img = _img2ch((2, 9, 11), "u8", 11).to(torch.uint8)
    p = _leaves()
    assert torch.equal(_front(img, p), _chain(img.to(torch.float32), _leaves()))
    wide = _img2ch((2, 9, 22), "u8", 12)[:, :, ::2]
    assert not wide.is_contiguous()
    assert torch.equal(_front(wide, p), _chain(wide, _leaves()))


def test_the_plain_path_launches_nothing():
    before = dict(soft_front.LAUNCHES)
    p = _leaves()
    soft_front.mse(_front(_img2ch((5, 7), "u8", 0), p), _target((5, 7), 1), 35).backward()
    assert soft_front.LAUNCHES == before


def test_train_step_loss_is_the_mean_of_squares():
    """The model's training step reports mse of its own field, as the chain
    did: the mean of the float32 squares within float32 rounding."""
    rng = np.random.default_rng(10)
    img = torch.from_numpy((rng.random((2, 20, 18, 2)) * 255).astype(np.float32))
    target = _target((2, 20, 18), 11)
    model = tsm.SoftSDFModel(6, SoftConfig(tau=2.0, temperature=1.0), device="cpu")
    with torch.no_grad():
        want = torch.mean((model(img).double() - target.double()) ** 2)
    loss = tsm.make_train_step(model, tsm.create_train_state(model))(img, target)
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in model.parameters())
