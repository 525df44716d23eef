"""The port's checkpoints (models/checkpoint.py) and the carry-over of an
optax Adam state (soft_model.opt_state_from_jax), on the CPU: the four
cases of tests/test_checkpoint.py, a resumed Adam step bit for bit the
uninterrupted one, and a JAX training run resumed in the port."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import chaq_sdfgen_tpu.config as jcfg
import chaq_sdfgen_tpu.models.soft_model as jsm
from chaq_sdfgen_tpu_torch.config import SoftConfig
from chaq_sdfgen_tpu_torch.models import checkpoint as ckpt
from chaq_sdfgen_tpu_torch.models import soft_model as tsm

SPREAD, TAU, T = 4, 20.0, 1.0


def _batch(seed=0, shape=(2, 16, 16)):
    """tests/test_checkpoint.py's inputs: noise in alpha, 255 in gray, a
    standard normal target."""
    rng = np.random.default_rng(seed)
    gray = (rng.random(shape) * 255).astype(np.float32)
    img2ch = np.stack([np.full_like(gray, 255.0), gray], axis=-1)
    target = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(img2ch), torch.from_numpy(target)


def _trainer(lr=1e-2):
    model = tsm.SoftSDFModel(SPREAD, SoftConfig(tau=TAU, temperature=T), device="cpu")
    opt = tsm.create_train_state(model, lr=lr)
    return model, opt, tsm.make_train_step(model, opt)


def _assert_trees_equal(a, b):
    """Two state_dicts (nested dicts and lists) equal leaf for leaf, tensors
    bit for bit with their dtypes."""
    la, lb = list(ckpt._leaves(a)), list(ckpt._leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def test_train_state_roundtrip(tmp_path):
    """Saved and restored against templates (the model and the optimizer):
    the same tensors, and the resumed step's loss equals the original's."""
    img2ch, target = _batch()
    model, opt, step = _trainer()
    step(img2ch, target)
    path = str(tmp_path / "ckpt" / "state.pt")
    ckpt.save_train_state(path, model, opt, step=1)
    p2, o2, s2 = ckpt.restore_train_state(path, like_params=model, like_opt=opt)
    assert s2 == 1
    _assert_trees_equal(p2, model.state_dict())
    _assert_trees_equal(o2, opt.state_dict())
    model2, opt2, step2 = _trainer()
    model2.load_state_dict(p2)
    opt2.load_state_dict(o2)
    assert float(step2(img2ch, target)) == float(step(img2ch, target))


def test_train_state_restore_without_template(tmp_path):
    """No templates: the stored dtypes and values, the step, and a resumed
    step equal to the original's; state_dicts saved as such."""
    img2ch, target = _batch(seed=1)
    model, opt, step = _trainer()
    step(img2ch, target)
    path = str(tmp_path / "ckpt_nt.pt")
    ckpt.save_train_state(path, model.state_dict(), opt.state_dict(), step=7)
    p2, o2, s2 = ckpt.restore_train_state(path)
    assert s2 == 7
    for k, v in model.state_dict().items():
        assert p2[k].dtype == v.dtype and p2[k].device.type == "cpu" and torch.equal(p2[k], v)
    model2, opt2, step2 = _trainer()
    model2.load_state_dict(p2)
    opt2.load_state_dict(o2)
    assert float(step2(img2ch, target)) == float(step(img2ch, target))


def test_dump_grid(tmp_path):
    arr = np.arange(12.0).reshape(3, 4)
    fp = ckpt.dump_grid(str(tmp_path / "grids"), "edt_inside", arr)
    np.testing.assert_array_equal(np.load(fp), arr)
    t = torch.arange(6, dtype=torch.int16).reshape(2, 3)
    fp = ckpt.dump_grid(str(tmp_path / "grids"), "rows", t)
    got = np.load(fp)
    assert got.dtype == np.int16 and (got == t.numpy()).all()


def test_restore_rejects_non_train_state(tmp_path):
    """A file without the three keys, or not a dict, raises ValueError; so
    do templates whose names, shapes or dtypes differ."""
    path = str(tmp_path / "bogus.pt")
    torch.save({"something": torch.zeros(3)}, path)
    with pytest.raises(ValueError, match="not a train state"):
        ckpt.restore_train_state(path)
    torch.save([torch.zeros(3)], path)
    with pytest.raises(ValueError, match="not a train state"):
        ckpt.restore_train_state(path)
    model, opt, _ = _trainer()
    ckpt.save_train_state(path, model, opt, step=0)
    other = {k: v.to(torch.float64) for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape or dtype"):
        ckpt.restore_train_state(path, like_params=other)
    with pytest.raises(ValueError, match="names"):
        ckpt.restore_train_state(path, like_params={"threshold_bias": torch.zeros(())})


def test_resumed_adam_step_is_bit_for_bit(tmp_path):
    """Two Adam steps, save, restore into a fresh model and optimizer, a
    third step: parameters and optimizer state bit for bit the third step
    of the uninterrupted run."""
    img2ch, target = _batch(seed=2)
    model, opt, step = _trainer(lr=5e-2)
    for _ in range(2):
        step(img2ch, target)
    path = str(tmp_path / "two.pt")
    ckpt.save_train_state(path, model, opt, step=2)
    loss = step(img2ch, target)

    model2, opt2, step2 = _trainer(lr=5e-2)
    params, opt_state, n = ckpt.restore_train_state(path, like_params=model2, like_opt=opt2)
    assert n == 2
    model2.load_state_dict(params)
    opt2.load_state_dict(opt_state)
    assert torch.equal(step2(img2ch, target), loss)
    _assert_trees_equal(model2.state_dict(), model.state_dict())
    _assert_trees_equal(opt2.state_dict(), opt.state_dict())


def test_optax_adam_state_resumes_in_the_port():
    """Two optax.adam steps of the JAX SoftSDFModel, carried over by
    params_from_jax and opt_state_from_jax, then one more step on each
    side: parameters within 1e-4 (test_torch_soft_model.py's
    test_three_adam_steps_match_optax tolerance) and the Adam moments
    within 1e-4 of their scale."""
    lr = 5e-2
    img2ch, target = _batch(seed=3)
    jm = jsm.SoftSDFModel(spread=SPREAD, soft=jcfg.SoftConfig(tau=TAU, temperature=T))
    params, opt_state, tx = jsm.create_train_state(jm, jnp.asarray(img2ch.numpy()), lr=lr)
    j_step = jax.jit(jsm.make_train_step(jm, tx))
    for _ in range(2):
        params, opt_state, _ = j_step(params, opt_state, jnp.asarray(img2ch.numpy()), jnp.asarray(target.numpy()))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    np_opt = jax.tree_util.tree_map(np.asarray, opt_state)

    model, opt, step = _trainer(lr=lr)
    model.load_state_dict(tsm.params_from_jax(np_params))
    sd = tsm.opt_state_from_jax(np_opt, np_params, lr=lr)
    _assert_trees_equal(sd["param_groups"], opt.state_dict()["param_groups"])
    opt.load_state_dict(sd)
    assert float(opt.state_dict()["state"][0]["step"]) == 2.0

    params, opt_state, _ = j_step(params, opt_state, jnp.asarray(img2ch.numpy()), jnp.asarray(target.numpy()))
    step(img2ch, target)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["params"][k]), atol=1e-4, rtol=0)
    adam = opt_state[0]
    assert int(adam.count) == 3
    for i, k in enumerate(tsm.PARAM_NAMES):
        st = opt.state_dict()["state"][i]
        for name, want in (("exp_avg", adam.mu["params"][k]), ("exp_avg_sq", adam.nu["params"][k])):
            want = np.asarray(want)
            np.testing.assert_allclose(st[name].numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_opt_state_from_jax_finds_the_adam_state_and_refuses_others():
    """The ScaleByAdamState alone or inside a chain tuple (as optax.adam
    builds it); a state with no Adam moments raises ValueError."""
    params = {"params": {"threshold_bias": 0.0, "log_tau": 1.0, "channel_mix": [0.0, 4.0]}}
    adam = optax.ScaleByAdamState(count=np.int32(5), mu=params, nu=params)
    for state in (adam, (adam, optax.EmptyState()), ((optax.EmptyState(), adam),)):
        sd = tsm.opt_state_from_jax(state, params)
        assert [float(sd["state"][i]["step"]) for i in range(3)] == [5.0] * 3
        assert torch.equal(sd["state"][2]["exp_avg"], torch.tensor([0.0, 4.0]))
    assert sd["param_groups"][0]["lr"] == 1e-2 and sd["param_groups"][0]["params"] == [0, 1, 2]
    with pytest.raises(ValueError, match="no Adam state"):
        tsm.opt_state_from_jax((optax.EmptyState(), {"count": 1}), params)
