"""The port's trainable SoftSDFModel (models/soft_model.py) against the JAX
package's flax model and optax training step, on the CPU: the parameter
carry-over, the forward and the parameter gradients, and Adam steps.

On the CPU the flax model takes JAX's composed path. At tau 20, T 1 and
spread 6 its largest height is 6.4 (an image in [0, 255]), below the
composed path's clip (band + 1)^2 = 81, so that path and the port's gated
branch (the runtime-shift kernels, here) compute the same field. The
out-of-gamut case holds the port against the JAX adaptive kernels in
interpret mode instead, monkeypatched into the flax model for that test
only."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chaq_sdfgen_tpu.config as jcfg
import chaq_sdfgen_tpu.models.soft_model as jsm
from chaq_sdfgen_tpu.ops import edt as jedt
from chaq_sdfgen_tpu.ops import merge as jmerge
from chaq_sdfgen_tpu.ops import pallas_soft_fused as JF
from chaq_sdfgen_tpu_torch.config import SoftConfig
from chaq_sdfgen_tpu_torch.models import soft_model as tsm
from chaq_sdfgen_tpu_torch.ops import softsdf

SPREAD, TAU, T = 6, 20.0, 1.0


def _batch(shape=(2, 24, 24), seed=0):
    """The inputs of tests/test_model_and_entry.py:11-40: noise in alpha,
    255 in gray, and the hard signed field of alpha > 127 as the target."""
    rng = np.random.default_rng(seed)
    gray = (rng.random(shape) * 255).astype(np.float32)
    img2ch = np.stack([np.full_like(gray, 255.0), gray], axis=-1)
    d_in, d_out = jedt.dual_edt_banded(jnp.asarray(gray > 127), SPREAD + 2)
    return img2ch, np.array(jmerge.signed_merge(d_out, d_in), np.float32)


def _models(tau=TAU, t=T, img2ch=None):
    jm = jsm.SoftSDFModel(spread=SPREAD, soft=jcfg.SoftConfig(tau=tau, temperature=t))
    params = jm.init(jax.random.key(0), jnp.asarray(img2ch))
    tm = tsm.SoftSDFModel(SPREAD, SoftConfig(tau=tau, temperature=t), device="cpu")
    tm.load_state_dict(tsm.params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _jax_loss_and_grads(jm, params, img2ch, target):
    def loss_fn(p):
        return jnp.mean((jm.apply(p, jnp.asarray(img2ch)) - jnp.asarray(target)) ** 2)
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {k: np.asarray(v) for k, v in grads["params"].items()}


def _port_loss_and_grads(tm, img2ch, target):
    tm.zero_grad(set_to_none=True)
    loss = torch.mean((tm(torch.from_numpy(img2ch)) - torch.from_numpy(target)) ** 2)
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in tm.named_parameters()}


@pytest.mark.parametrize("tau", [TAU, 4.0])
def test_params_from_jax_round_trips_a_flax_init(tau):
    img2ch, _ = _batch()
    jm = jsm.SoftSDFModel(spread=SPREAD, soft=jcfg.SoftConfig(tau=tau, temperature=T))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(img2ch)))
    sd = tsm.params_from_jax(params)
    own = tsm.SoftSDFModel(SPREAD, SoftConfig(tau=tau, temperature=T), device="cpu").state_dict()
    assert set(sd) == set(own) == set(tsm.PARAM_NAMES)
    for k in sd:
        assert sd[k].dtype == torch.float32 and sd[k].shape == own[k].shape
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(params["params"][k]))
        # the port's own init is flax's (log tau within an ulp of XLA's log)
        np.testing.assert_allclose(own[k].numpy(), sd[k].numpy(), rtol=2 ** -23, atol=0)
    tm = tsm.SoftSDFModel(SPREAD, SoftConfig(tau=tau, temperature=T), device="cpu")
    tm.load_state_dict(sd)
    for k, p in tm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(params["params"][k]))


def test_params_from_jax_refuses_other_trees():
    good = {"threshold_bias": 0.0, "log_tau": 1.0, "channel_mix": [0.0, 4.0]}
    assert set(tsm.params_from_jax({"params": good})) == set(good)
    with pytest.raises(ValueError):
        tsm.params_from_jax(good)  # a bare tree, without 'params'
    with pytest.raises(ValueError):
        tsm.params_from_jax({"params": {"log_tau": 1.0, "channel_mix": [0.0, 4.0]}})
    with pytest.raises(ValueError):
        tsm.params_from_jax({"params": dict(good, extra=1.0)})
    with pytest.raises(ValueError):
        tsm.params_from_jax({"params": dict(good, channel_mix=[1.0, 2.0, 3.0])})


@pytest.mark.parametrize("shape,seed", [((2, 24, 24), 0), ((1, 30, 26), 1), ((3, 16, 20), 2)])
def test_forward_and_parameter_gradients_match_flax(shape, seed):
    """Field within 1e-4; loss within 1e-5 relative; each parameter's
    gradient within 1e-3 of its size (they sum pixel gradients that agree
    within 1e-4 of their scale)."""
    img2ch, target = _batch(shape, seed)
    jm, params, tm = _models(img2ch=img2ch)
    g = jnp.asarray(img2ch)
    np.testing.assert_allclose(tm(torch.from_numpy(img2ch)).detach().numpy(),
                               np.asarray(jm.apply(params, g)), atol=1e-4, rtol=0)
    j_loss, j_grads = _jax_loss_and_grads(jm, params, img2ch, target)
    t_loss, t_grads = _port_loss_and_grads(tm, img2ch, target)
    assert abs(t_loss - j_loss) <= 1e-5 * abs(j_loss)
    for k in tsm.PARAM_NAMES:
        np.testing.assert_allclose(t_grads[k], j_grads[k], rtol=1e-3, atol=1e-3 * np.abs(j_grads[k]).max())


def test_model_takes_the_runtime_shift_branch_here():
    img2ch, _ = _batch()
    _, _, tm = _models(img2ch=img2ch)
    with torch.no_grad():
        mix = torch.softmax(tm.channel_mix, 0)
        v = (torch.from_numpy(img2ch) * mix).sum(-1)
    assert softsdf.runtime_gate(v, SPREAD + 2, TAU, T) is not None


def test_out_of_gamut_matches_flax_on_the_jax_kernels(monkeypatch):
    """Values in +-2000 at tau 2, T 1: the port's gate picks the adaptive
    kernels; the flax model runs them too (JAX's soft_sdf_field replaced
    by soft_sdf_field_fused in interpret mode for this test). Field within
    1e-4, loss within 1e-5 relative, parameter gradients within 1e-2 of
    their size (JAX's dS1 is bf16)."""
    tau = 2.0
    rng = np.random.default_rng(5)
    img2ch = (rng.random((40, 36, 2)) * 4000 - 2000).astype(np.float32)
    target = rng.standard_normal((40, 36)).astype(np.float32)

    def fused(v, spread, tau, temperature, eps):
        return JF.soft_sdf_field_fused(v, spread + 2, tau, temperature, eps, True, True)

    monkeypatch.setattr(jsm.softsdf, "soft_sdf_field", fused)
    jm, params, tm = _models(tau=tau, img2ch=img2ch)
    with torch.no_grad():
        v = (torch.from_numpy(img2ch) * torch.softmax(tm.channel_mix, 0)).sum(-1)
    assert softsdf.runtime_gate(v, SPREAD + 2, tau, T) is None
    np.testing.assert_allclose(tm(torch.from_numpy(img2ch)).detach().numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(img2ch))), atol=1e-4, rtol=0)
    j_loss, j_grads = _jax_loss_and_grads(jm, params, img2ch, target)
    t_loss, t_grads = _port_loss_and_grads(tm, img2ch, target)
    assert abs(t_loss - j_loss) <= 1e-5 * abs(j_loss)
    for k in tsm.PARAM_NAMES:
        np.testing.assert_allclose(t_grads[k], j_grads[k], rtol=1e-2, atol=1e-2 * np.abs(j_grads[k]).max())


def test_three_adam_steps_match_optax():
    """create_train_state + make_train_step against optax.adam and the flax
    step (lr 5e-2, the JAX test's): losses within 1e-4 relative and falling,
    parameters within 1e-4 after each step."""
    img2ch, target = _batch()
    jm, params, tm = _models(img2ch=img2ch)
    tx = optax.adam(5e-2)
    opt_state = tx.init(params)
    j_step = jax.jit(jsm.make_train_step(jm, tx))
    opt = tsm.create_train_state(tm, torch.from_numpy(img2ch), lr=5e-2)
    t_step = tsm.make_train_step(tm, opt)
    losses = []
    for _ in range(3):
        params, opt_state, j_loss = j_step(params, opt_state, jnp.asarray(img2ch), jnp.asarray(target))
        t_loss = float(t_step(torch.from_numpy(img2ch), torch.from_numpy(target)))
        assert abs(t_loss - float(j_loss)) <= 1e-4 * abs(float(j_loss))
        for k, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["params"][k]), atol=1e-4, rtol=0)
        losses.append(t_loss)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_create_train_state_is_optax_adam():
    tm = tsm.SoftSDFModel(SPREAD, SoftConfig(tau=TAU, temperature=T), device="cpu")
    opt = tsm.create_train_state(tm, lr=1e-3)
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam)
    assert group["lr"] == 1e-3 and group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert len(group["params"]) == 3


def test_mesh_and_no_card(monkeypatch):
    """With a mesh the parameters live on its first device and the field
    is the sharded one (2 shards of 12 rows: the composed tier, the field
    of one device's composed path bit for bit); with no card and no device
    the model refuses to start."""
    from chaq_sdfgen_tpu_torch.parallel.mesh import make_mesh

    img2ch, _ = _batch()
    tm = tsm.SoftSDFModel(SPREAD, SoftConfig(tau=TAU, temperature=T), mesh=make_mesh((2,), devices="cpu"))
    assert tm.log_tau.device == torch.device("cpu")
    x = torch.from_numpy(img2ch[0])
    with torch.no_grad():
        gray = (x * torch.softmax(tm.channel_mix, 0)).sum(-1) - tm.threshold_bias
        want = softsdf.soft_field_cols((gray - 127.5) / torch.exp(tm.log_tau) * TAU + 127.5, SPREAD + 2, TAU, T,
                                       1e-6)
    assert torch.equal(tm(x).detach(), want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsm.SoftSDFModel(SPREAD, SoftConfig())
