"""The port's multi-host tier on the CPU: two processes joined by
``distributed.initialize`` (torch.distributed over gloo), the ('data', 'y')
``global_mesh`` across them, ``atlas_sdf`` and the ``SoftSDFModel`` Adam
step with the batch split over the processes, a checkpoint written once;
and meshes whose 'y' (or 'x') lines cross the processes, their halos by
point-to-point: a (4,) 'y' mesh of 2 logical CPU shards a process (by
``make_mesh``'s default and by ``ShardingConfig.build_mesh``) under the
sharded EXACT, BRUTE and JFA pipelines (multi-hop included, both halo
forms), the soft tiers 1a, 2 and 3 (field and gradient), a (2, 2) 'x'
line across them, ``SDFGenerator(sharding=...)``, a ('data', 'y') mesh
with processes [[0, 1], [0, 1]] under ``SoftSDFModel``'s steps, and the
(1, 8) mesh whose 'y' line crosses them.

The parent spawns the two workers once (this file, run as a script: it
imports torch, numpy and the port, never JAX), each over 4 logical CPU
devices as tests/dcn_worker.py's processes hold 4 virtual ones (2 on the
crossing meshes). They write what they computed to .npz files, which the
tests hold against the JAX package (hard_sdf_exact byte for byte; its
sharded pipelines under jax.jit over a (4,) mesh of its virtual CPU
devices; the flax model's jitted optax step) and against the port in one
process."""

import os
import sys

import numpy as np

ATLAS_SPREAD = 6
SPREAD, TAU, T, LR = 6, 20.0, 1.0, 5e-2
PARAM_NAMES = ("threshold_bias", "log_tau", "channel_mix")
HALOS = ("ppermute", "rdma")
HARD_SPREADS = (6, 20, 300)  # one hop; band 22 > 16-row shards (two hops); uint16 strips
BRUTE_SPREADS = (6, 20)
# the soft tiers across processes, spread 6, tau 2, T 1: (input, keyword
# arguments); tiers 2 and 3 on one 64 x 40 input, both held against JAX's
# composed tier (float32; its height clip does not bind at band 8)
SOFT_TAU = 2.0
SOFT_CASES = {
    "1a": ("soft_1a", dict(gray_range=(0.0, 255.0), use_mm=True)),
    "2": ("soft_64", dict(use_fused=True, fused_impl="split")),
    "3": ("soft_64", dict(use_fused=False)),
}
SOFT_INPUTS = {"soft_1a": ((512, 48), (0.0, 255.0)), "soft_64": ((64, 40), None), "soft_2d": ((256, 256), (0.0, 255.0))}


def _flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(p, np.float32).ravel() for p in params])


def worker(pid: int, port: str, tmp: str) -> None:
    """One process of the run: everything it computed into worker{pid}.npz."""
    import torch

    from chaq_sdfgen_tpu_torch.config import SdfConfig, SoftConfig
    from chaq_sdfgen_tpu_torch.models import atlas, checkpoint, soft_model
    from chaq_sdfgen_tpu_torch.ops import threshold
    from chaq_sdfgen_tpu_torch.parallel import distributed, sharded
    from chaq_sdfgen_tpu_torch.parallel.mesh import Mesh, local_index, localize

    distributed.initialize(f"127.0.0.1:{port}", 2, pid, backend="gloo")  # CPU meshes, on any host
    inputs = np.load(os.path.join(tmp, "inputs.npz"))
    out = {"backend": torch.distributed.get_backend(), "rank": torch.distributed.get_rank()}

    imgs = inputs["atlas"]
    cfg = SdfConfig(spread=ATLAS_SPREAD)
    for y in (4, 2):
        mesh = distributed.global_mesh(y_per_host=y, devices=["cpu"] * 4)
        rows = atlas.atlas_sdf(imgs, cfg, mesh=mesh)
        index = local_index(imgs.shape[:-1], mesh, ("data", "y", None))
        out[f"atlas_y{y}"] = rows.numpy()
        out[f"index_y{y}"] = np.array([index[0].start, index[0].stop])
        out[f"processes_y{y}"] = mesh.processes
        out[f"shape_y{y}"] = np.array(mesh.devices.shape)
    # the pipelines themselves on the global tensor: this process's part only
    mesh = distributed.global_mesh(y_per_host=4, devices=["cpu"] * 4)
    b = threshold.hard_threshold(torch.from_numpy(imgs))
    part, local = localize(b, mesh, ("data", "y", None))
    out["local_part"] = np.array(part.shape)
    out["local_mesh"] = np.array(local.devices.shape)
    out["local_spans"] = local.spans_processes
    out["direct_hard"] = sharded.sharded_hard_sdf_bytes(b, ATLAS_SPREAD, mesh, batch_axis="data").numpy()
    out["direct_brute"] = sharded.sharded_brute_sdf_bytes(b, ATLAS_SPREAD, mesh, batch_axis="data").numpy()
    out["direct_jfa"] = sharded.sharded_jfa_distance(b[0], mesh).numpy()  # replicated over 'data'
    out["direct_soft"] = sharded.sharded_soft_sdf_field(torch.from_numpy(imgs[..., 1]), ATLAS_SPREAD, mesh, tau=TAU,
                                                        temperature=T, batch_axis="data").numpy()

    img2ch, target = torch.from_numpy(inputs["img2ch"]), torch.from_numpy(inputs["target"])
    mesh = distributed.global_mesh(y_per_host=2, devices=["cpu"] * 2)
    model = soft_model.SoftSDFModel(SPREAD, SoftConfig(tau=TAU, temperature=T), mesh=mesh, batch_axis="data")
    with torch.no_grad():
        out["field"] = model(img2ch).numpy()
    out["field_index"] = np.array([model.own_rows(target.shape)[0].start, model.own_rows(target.shape)[0].stop])
    opt = soft_model.create_train_state(model, lr=LR)
    step = soft_model.make_train_step(model, opt)
    losses, params = [], []
    for _ in range(2):
        losses.append(float(step(img2ch, target)))
        params.append(_flat(p.detach() for p in model.parameters()))
    out["losses"], out["params"] = np.array(losses), np.stack(params)

    # the checkpoint: process 0 writes, both return after the file is there
    path = os.path.join(tmp, "ckpt", "state.pt")
    saves, save = [], torch.save
    torch.save = lambda *a, **k: (saves.append(1), save(*a, **k))
    checkpoint.save_train_state(path, model, opt, step=2)
    torch.save = save
    out["saves"], out["ckpt_seen"] = len(saves), os.path.exists(path)
    restored, _, out["ckpt_step"] = checkpoint.restore_train_state(path, like_params=model, like_opt=opt)
    out["ckpt_params"] = _flat(restored[k] for k in PARAM_NAMES)

    # the (1, 8) mesh whose 'y' line crosses the processes
    g = distributed.global_mesh(devices=["cpu"] * 4)
    cross = Mesh(g.devices.reshape(1, 8), ("data", "y"), g.processes.reshape(1, 8), g.process)
    out["cross_index"] = np.array([[s.start, s.stop] for s in local_index(imgs.shape[:-1], cross, ("data", "y", None))])
    out["cross_atlas"] = atlas.atlas_sdf(imgs, cfg, mesh=cross).numpy()
    out["cross_sharded"] = sharded.sharded_hard_sdf_bytes(b, ATLAS_SPREAD, cross, batch_axis="data").numpy()
    out["cross_soft"] = sharded.sharded_soft_sdf_field(b.float(), ATLAS_SPREAD, cross, batch_axis="data").numpy()
    with torch.no_grad():
        out["cross_model"] = soft_model.SoftSDFModel(SPREAD, mesh=cross, batch_axis="data")(img2ch).numpy()

    crossing(out, inputs, img2ch, target)

    # refusals: a 'data' line across the processes under a model with no
    # batch axis, unequal device counts, entries that form no block
    twisted = Mesh(g.devices.reshape(-1)[:4].reshape(2, 2), ("y", "x"), np.array([[0, 1], [1, 0]]), g.process)
    for name, fn in (("model_unbatched", lambda: soft_model.SoftSDFModel(SPREAD, mesh=mesh)),
                     ("counts", lambda: distributed.global_mesh(devices=["cpu"] * (4 if pid == 0 else 2))),
                     ("no_block", lambda: sharded.sharded_hard_sdf_bytes(b[0], ATLAS_SPREAD, twisted, x_axis="x"))):
        try:
            fn()
            out[f"refused_{name}"] = ""
        except ValueError as e:
            out[f"refused_{name}"] = str(e)

    torch.distributed.destroy_process_group()
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "chaq_sdfgen_tpu") for m in sys.modules)
    np.savez(os.path.join(tmp, f"worker{pid}.npz"), **out)
    print(f"DIST_OK p{pid}", flush=True)


def crossing(out: dict, inputs, img2ch, target) -> None:
    """The meshes whose lines cross the processes, each result this
    process's part of the global one (its rows, at out[...+"_index"])."""
    import torch

    from chaq_sdfgen_tpu_torch.config import Algorithm, SdfConfig, ShardingConfig, SoftConfig
    from chaq_sdfgen_tpu_torch.models import soft_model
    from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
    from chaq_sdfgen_tpu_torch.parallel import halo, sharded
    from chaq_sdfgen_tpu_torch.parallel.mesh import Mesh, local_index, make_mesh, spanning_mesh

    ym = make_mesh((4,), devices="cpu")  # every process's 2 logical shards, in rank order
    built = ShardingConfig((4,)).build_mesh("cpu")
    out["y_processes"], out["built_processes"] = ym.processes, built.processes
    out["spanning_processes"] = spanning_mesh((4,), ("y",), ["cpu"] * 2).processes
    own = make_mesh((4,), devices=["cpu"] * 4)  # a list: this process's devices alone
    out["own_processes"], out["own_spans"] = own.processes, own.spans_processes
    b = torch.from_numpy(inputs["mask"])
    out["y_index"] = np.array([[s.start, s.stop] for s in local_index(b.shape, ym, ("y", None))])
    for impl in HALOS:
        for spread in HARD_SPREADS:
            out[f"y_hard_{impl}_{spread}"] = sharded.sharded_hard_sdf_bytes(b, spread, ym, halo=impl).numpy()
        for spread in BRUTE_SPREADS:
            out[f"y_brute_{impl}_{spread}"] = sharded.sharded_brute_sdf_bytes(b, spread, built, halo=impl).numpy()
    out["y_jfa"] = sharded.sharded_jfa_distance(b, ym).numpy()
    legs = dict(halo.P2P)

    # an 'x' line across the processes: ('x', 'y') (2, 2), processes [[0, 0], [1, 1]]
    xm = make_mesh((2, 2), ("x", "y"), devices="cpu")
    out["x_index"] = np.array([[s.start, s.stop] for s in local_index(b.shape, xm, ("y", "x"))])
    for impl in HALOS:
        out[f"x_hard_{impl}"] = sharded.sharded_hard_sdf_bytes(b, 20, xm, halo=impl, x_axis="x").numpy()
        out[f"x_brute_{impl}"] = sharded.sharded_brute_sdf_bytes(b, 6, xm, halo=impl, x_axis="x").numpy()
    out["x_jfa"] = sharded.sharded_jfa_distance(b, xm, x_axis="x").numpy()

    # the soft tiers: field and the gradient of sum(w * field) at this process's rows
    for case, (key, kw) in SOFT_CASES.items():
        g, w = inputs[key], inputs[f"{key}_w"]
        rows = local_index(g.shape, ym, ("y", None))
        out[f"soft_{case}_index"] = np.array([rows[0].start, rows[0].stop])
        for impl in HALOS:
            x = torch.from_numpy(g).requires_grad_()
            f = sharded.sharded_soft_sdf_field(x, 6, ym, tau=SOFT_TAU, temperature=1.0, halo=impl, **kw)
            (f * torch.from_numpy(w[rows])).sum().backward()
            out[f"soft_{case}_{impl}"] = f.detach().numpy()
            out[f"soft_{case}_{impl}_grad"] = x.grad.numpy()
    g, w = inputs["soft_2d"], inputs["soft_2d_w"]
    xy = make_mesh((2, 2), ("x", "y"), devices="cpu")
    rows = local_index(g.shape, xy, ("y", "x"))
    x = torch.from_numpy(g).requires_grad_()
    f = sharded.sharded_soft_sdf_field(x, 6, xy, tau=SOFT_TAU, temperature=1.0, gray_range=(0.0, 255.0), use_mm=True,
                                       x_axis="x", halo="rdma")
    (f * torch.from_numpy(w[rows])).sum().backward()
    out["soft_2d"], out["soft_2d_grad"] = f.detach().numpy(), x.grad.numpy()

    # the entry points
    img = inputs["image"]
    for algo in ("exact", "brute", "jfa"):
        gen = SDFGenerator(SdfConfig(spread=6, algorithm=Algorithm(algo)), sharding=ShardingConfig((4,)), device="cpu")
        out[f"gen_{algo}"] = gen.generate(img).numpy()
    out["gen_index"] = np.array([[s.start, s.stop] for s in gen.own_index(img.shape[:-1])])
    gen = SDFGenerator(SdfConfig(spread=6), soft=SoftConfig(tau=SOFT_TAU, temperature=1.0),
                       sharding=ShardingConfig((4,), halo_impl="rdma"), device="cpu")
    out["gen_soft"] = gen.generate_field(img).numpy()

    # SoftSDFModel over ('data', 'y') (2, 2), processes [[0, 1], [0, 1]]: 'y' across them
    t = make_mesh((2, 2), ("y", "data"), devices="cpu")
    mesh = Mesh(t.devices.T.copy(), ("data", "y"), t.processes.T.copy(), t.process)
    out["model_processes"] = mesh.processes
    model = soft_model.SoftSDFModel(SPREAD, SoftConfig(tau=TAU, temperature=T), mesh=mesh, batch_axis="data")
    out["model_index"] = np.array([[s.start, s.stop] for s in model.own_rows(target.shape)])
    step = soft_model.make_train_step(model, soft_model.create_train_state(model, lr=LR))
    losses, params = [], []
    for _ in range(2):
        losses.append(float(step(img2ch, target)))
        params.append(_flat(p.detach() for p in model.parameters()))
    out["y_losses"], out["y_params"] = np.array(losses), np.stack(params)
    out["legs"] = np.array([legs["exchanges"], legs["legs"], legs["bytes"]])


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
    sys.exit(0)


# ------------------------------------------------------------------ the tests (JAX from here on)

import socket  # noqa: E402
import subprocess  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chaq_sdfgen_tpu.config as jcfg  # noqa: E402
import chaq_sdfgen_tpu.models.sdf_model as jsdf  # noqa: E402
import chaq_sdfgen_tpu.models.soft_model as jsm  # noqa: E402
from chaq_sdfgen_tpu.models.sdf_model import hard_sdf_exact as j_hard_sdf_exact  # noqa: E402
from chaq_sdfgen_tpu.models.sdf_model import hard_sdf_exact_from_bool as j_exact_from_bool  # noqa: E402
from chaq_sdfgen_tpu.ops import brute as jbrute  # noqa: E402
from chaq_sdfgen_tpu.ops import edt as jedt  # noqa: E402
from chaq_sdfgen_tpu.ops import jfa as jjfa  # noqa: E402
from chaq_sdfgen_tpu.ops import merge as jmerge  # noqa: E402
from chaq_sdfgen_tpu.parallel import mesh as jmesh  # noqa: E402
from chaq_sdfgen_tpu.parallel import sharded as jsharded  # noqa: E402
from chaq_sdfgen_tpu_torch.config import Algorithm, SdfConfig, ShardingConfig, SoftConfig  # noqa: E402
from chaq_sdfgen_tpu_torch.models import checkpoint, soft_model  # noqa: E402
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator  # noqa: E402
from chaq_sdfgen_tpu_torch.ops import cuda_brute, jfa, soft_fused, soft_mxu, threshold  # noqa: E402
from chaq_sdfgen_tpu_torch.parallel import sharded  # noqa: E402
from chaq_sdfgen_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

KNEE = 1e-3  # |d2| below this marks a sigmoid-knee output (ROADMAP Queue 3 item 1)


def _inputs():
    """The JAX DCN test's glyph stack (tests/dcn_worker.py:50-54, 4 images
    of 32 x 24) and a (2, 32, 32, 2) training batch made as
    tests/test_torch_soft_model.py's: noise in alpha, the hard signed field
    as the target."""
    rng = np.random.default_rng(42)
    imgs = np.zeros((4, 32, 24, 2), dtype=np.uint8)
    imgs[..., 1] = np.where(rng.random((4, 32, 24)) < 0.4, 255, 0)
    imgs[..., 0] = 128
    gray = (np.random.default_rng(0).random((2, 32, 32)) * 255).astype(np.float32)
    img2ch = np.stack([np.full_like(gray, 255.0), gray], axis=-1)
    d_in, d_out = jedt.dual_edt_banded(jnp.asarray(gray > 127), SPREAD + 2)
    return imgs, img2ch, np.array(jmerge.signed_merge(d_out, d_in), np.float32)


def _crossing_inputs():
    """The crossing meshes' inputs: a 64 x 48 mask (16-row shards over 4)
    and its gray+alpha image, the soft tiers' smooth images in [0, 255]
    with a random cotangent each, zeroed at sigmoid-knee outputs (|d2| <
    1e-3 in the single-device memos), and a 256 x 256 one for tier 1a on a
    (2, 2) mesh."""
    rng = np.random.default_rng(20)
    mask = rng.random((64, 48)) < 0.1
    image = np.stack([np.full(mask.shape, 128, np.uint8), np.where(mask, 255, 0).astype(np.uint8)], -1)
    out = dict(mask=mask, image=image)
    for key, (shape, gray_range) in SOFT_INPUTS.items():
        g = _smooth(shape, rng)
        w = rng.standard_normal(shape).astype(np.float32)
        x, band = torch.from_numpy(g), 8
        if gray_range is not None:
            k1, k2, shift = soft_mxu.range_stats(band, SOFT_TAU, 1.0, gray_range)
            d2i, d2o = (m.numpy() for m in soft_mxu.soft_field_collapsed(x, k1, k2, shift, SOFT_TAU, 1.0, 1e-6)[1:])
        else:
            d2 = soft_fused.f2_plain(soft_fused.f1_plain(x, band, SOFT_TAU, 1.0), band, 1.0, 1e-6)[1].numpy()
            d2i, d2o = d2[0], d2[1]
        knee = (np.abs(d2i) < KNEE) | (np.abs(d2o) < KNEE)
        assert knee.mean() < 5e-3
        out[key], out[f"{key}_w"] = g, np.where(knee, 0, w).astype(np.float32)
    return out


def _smooth(shape, rng, cell=8):
    """Bilinear noise on a ``cell`` grid, steep around 127.5, in [0, 255]
    (tests/test_torch_sharded_soft.py's _blobs)."""
    h, w = shape
    lo = rng.random((h // cell + 2, w // cell + 2))
    y, x = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = y.astype(int), x.astype(int)
    fy, fx = (y - y0)[:, None], (x - x0)[None, :]
    v = (lo[y0][:, x0] * (1 - fy) * (1 - fx) + lo[y0 + 1][:, x0] * fy * (1 - fx)
         + lo[y0][:, x0 + 1] * (1 - fy) * fx + lo[y0 + 1][:, x0 + 1] * fy * fx)
    return np.clip((v - 0.5) * 1020 + 127.5, 0, 255).astype(np.float32)


def _jit(fn, *args):
    return jax.jit(fn)(*(jnp.asarray(a) for a in args))


def _jax_crossing(inp):
    """JAX's sharded pipelines over a (4,) mesh of its virtual CPU devices
    on the crossing inputs, each under jax.jit: EXACT at each spread, BRUTE
    at spread 20 (two hops), JFA, and the soft tiers 1a and 3 (the
    reference of tier 2 too): the field and the gradient of vdot(field,
    w), one compile a tier through jax.vjp; and the single-device EXACT at
    spread 20, BRUTE at 6 (the sharded BRUTE's at 6 too: JAX's sharded
    BRUTE equals it, tests/test_torch_sharded.py) and JFA."""
    jm = jmesh.make_mesh((4,), ("y",))
    b = inp["mask"]
    refs = {f"hard_{s}": _jit(lambda x, s=s: jsharded.sharded_hard_sdf_bytes(x, s, jm, use_pallas=False), b)
            for s in HARD_SPREADS}
    refs["brute_20"] = _jit(lambda x: jsharded.sharded_brute_sdf_bytes(x, 20, jm), b)
    refs["jfa"] = _jit(lambda x: jsharded.sharded_jfa_distance(x, jm), b)
    refs["x_hard"] = _jit(lambda x: j_exact_from_bool(x, 20, use_pallas=False), b)
    refs["x_brute"] = refs["brute_6"] = _jit(lambda x: jbrute.brute_sdf_bytes(x, 6), b)
    refs["x_jfa"] = _jit(jjfa.jfa_distance, b)
    for case in ("1a", "3"):
        key, kw = SOFT_CASES[case]

        def both(x, c, kw=kw):
            f, vjp = jax.vjp(lambda v: jsharded.sharded_soft_sdf_field(v, 6, jm, tau=SOFT_TAU, temperature=1.0,
                                                                        eps=1e-6, interpret=True, **kw), x)
            return f, vjp(c)[0]
        refs[f"soft_{case}"] = _jit(both, inp[key], inp[f"{key}_w"])
    refs["soft_2"] = refs["soft_3"]

    def tiles(x, c):  # tier 1a over ('x', 'y') (2, 2), as the workers' 'x' line across them
        f, vjp = jax.vjp(lambda v: jsharded.sharded_soft_sdf_field(
            v, 6, jmesh.make_mesh((2, 2), ("x", "y")), tau=SOFT_TAU, temperature=1.0, eps=1e-6, interpret=True,
            gray_range=(0.0, 255.0), use_mm=True, x_axis="x"), x)
        return f, vjp(c)[0]
    refs["soft_2d"] = _jit(tiles, inp["soft_2d"], inp["soft_2d_w"])
    gen = jsdf.SDFGenerator(jcfg.SdfConfig(spread=6), soft=jcfg.SoftConfig(tau=SOFT_TAU, temperature=1.0),
                            sharding=jcfg.ShardingConfig((4,)))
    refs["gen_soft"] = gen.generate_field(jnp.asarray(inp["image"]))
    return jax.tree.map(np.asarray, refs)


def _jax_cross_line(imgs, img2ch):
    """JAX over the (1, 8) ('data', 'y') mesh of its virtual CPU devices:
    the sharded soft field of the thresholded glyphs (the composed tier on
    4-row shards) and the flax model's forward from its own init."""
    jm = jmesh.make_mesh((1, 8), ("data", "y"))
    b = (imgs[..., 1] > 127).astype(np.float32)
    soft = _jit(lambda x: jsharded.sharded_soft_sdf_field(x, ATLAS_SPREAD, jm, batch_axis="data", interpret=True), b)
    model = jsm.SoftSDFModel(spread=SPREAD, mesh=jm, batch_axis="data")
    params = jax.jit(model.init)(jax.random.key(0), jnp.asarray(img2ch))
    return dict(soft=np.asarray(soft), model=np.asarray(jax.jit(model.apply)(params, jnp.asarray(img2ch))))


def _port_crossing(inp, img2ch):
    """The port in one process on what the workers split: the soft tiers
    over a (4,) logical mesh and tier 1a over a (2, 2) ('x', 'y') one
    (field and gradient), the (1, 8) ('data', 'y') soft field and model
    forward, SDFGenerator on one device."""
    out = {}
    for case, (key, kw) in dict(SOFT_CASES, **{"2d": ("soft_2d", dict(
            gray_range=(0.0, 255.0), use_mm=True, x_axis="x"))}).items():
        m = make_mesh((2, 2), ("x", "y"), devices="cpu") if case == "2d" else make_mesh((4,), devices="cpu")
        x = torch.from_numpy(inp[key]).requires_grad_()
        f = sharded.sharded_soft_sdf_field(x, 6, m, tau=SOFT_TAU, temperature=1.0, **kw)
        (f * torch.from_numpy(inp[f"{key}_w"])).sum().backward()
        out[f"soft_{case}"] = (f.detach().numpy(), x.grad.numpy())
    return out


def _jax_atlas(imgs):
    return np.stack([np.asarray(j_hard_sdf_exact(jnp.asarray(imgs[i]), spread=ATLAS_SPREAD, use_pallas=False))
                     for i in range(len(imgs))])


def _jax_steps(img2ch, target):
    """Two steps of the flax model's jitted optax step on the whole batch,
    from its own init (the port's within an ulp)."""
    jm = jsm.SoftSDFModel(spread=SPREAD, soft=jcfg.SoftConfig(tau=TAU, temperature=T))
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(img2ch))
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    j_step = jax.jit(jsm.make_train_step(jm, tx))
    losses, flat = [], []
    for _ in range(2):
        params, opt_state, loss = j_step(params, opt_state, jnp.asarray(img2ch), jnp.asarray(target))
        losses.append(float(loss))
        flat.append(_flat(np.asarray(params["params"][k]) for k in PARAM_NAMES))
    return np.array(losses), np.stack(flat)


def _one_process(img2ch, target, mesh):
    """The port in one process on the whole batch: the initial field and
    two steps' losses and parameters."""
    model = soft_model.SoftSDFModel(SPREAD, SoftConfig(tau=TAU, temperature=T), mesh=mesh,
                                    batch_axis="data" if mesh is not None else None, device=None if mesh else "cpu")
    x, t = torch.from_numpy(img2ch), torch.from_numpy(target)
    with torch.no_grad():
        field = model(x).numpy()
    step = soft_model.make_train_step(model, soft_model.create_train_state(model, lr=LR))
    losses, flat = [], []
    for _ in range(2):
        losses.append(float(step(x, t)))
        flat.append(_flat(p.detach() for p in model.parameters()))
    return field, np.array(losses), np.stack(flat)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both workers, spawned once, their output in files (a pipe that fills
    would stall a worker and its peer with it); the references computed
    while they run; both killed together when either overruns."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    imgs, img2ch, target = _inputs()
    cross = _crossing_inputs()
    np.savez(os.path.join(tmp, "inputs.npz"), atlas=imgs, img2ch=img2ch, target=target, **cross)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(tmp, f"worker{pid}.log"), "w+") for pid in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(pid), str(port), tmp],
                              stdout=log, stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
             for pid, log in enumerate(logs)]
    try:
        refs = dict(atlas=_jax_atlas(imgs), jax_steps=_jax_steps(img2ch, target),
                    mesh_steps=_one_process(img2ch, target, make_mesh((2, 2), ("data", "y"), devices="cpu")),
                    device_steps=_one_process(img2ch, target, None), jax_cross=_jax_crossing(cross),
                    jax_line=_jax_cross_line(imgs, img2ch),
                    port_cross=_port_crossing(cross, img2ch))
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:
            p.kill()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        out = log.read()
        log.close()
        assert p.returncode == 0 and f"DIST_OK p{pid}" in out, f"worker {pid} rc={p.returncode}\n{out}"
    workers = [dict(np.load(os.path.join(tmp, f"worker{pid}.npz"))) for pid in range(2)]
    return dict(tmp=tmp, imgs=imgs, img2ch=img2ch, cross=cross, workers=workers, **refs)


def test_processes_join_over_gloo_without_jax(run):
    """initialize with 2 processes: gloo on the CPU, ranks 0 and 1; the
    workers imported neither jax nor the JAX package."""
    for pid, w in enumerate(run["workers"]):
        assert str(w["backend"]) == "gloo" and int(w["rank"]) == pid
        assert not bool(w["jax_imported"])


@pytest.mark.parametrize("y,layout", [(4, [[0] * 4, [1] * 4]), (2, [[0, 0], [0, 0], [1, 1], [1, 1]])])
def test_atlas_rows_match_jax(run, y, layout):
    """global_mesh(y_per_host=y) over 4 devices a process, laid out process
    by process; each process's rows of atlas_sdf byte for byte JAX's
    hard_sdf_exact (use_pallas=False) on its images, as the DCN worker
    holds its addressable shards (tests/dcn_worker.py:60-69)."""
    want = run["atlas"]
    for pid, w in enumerate(run["workers"]):
        assert w[f"processes_y{y}"].tolist() == layout and w[f"shape_y{y}"].tolist() == [8 // y, y]
        lo, hi = w[f"index_y{y}"].tolist()
        assert (lo, hi) == (2 * pid, 2 * pid + 2)
        np.testing.assert_array_equal(w[f"atlas_y{y}"], want[lo:hi])


@pytest.mark.parametrize("pipeline", ["hard", "brute", "jfa", "soft"])
def test_sharded_pipelines_take_the_global_tensor(run, pipeline):
    """The sharded pipelines on the global tensor over the global mesh
    ('data' 2, 'y' 4): run on this process's part (its 2 images, over its
    'data' row of 4 shards, a mesh of this process alone) and its rows out, byte or bit for bit one process (EXACT: the
    atlas's rows; BRUTE on one device; JFA, whose single image is
    replicated over 'data', whole; the soft field over a (2, 4) logical
    mesh, its rows)."""
    imgs = run["imgs"]
    b = threshold.hard_threshold(torch.from_numpy(imgs))
    if pipeline == "brute":
        want = cuda_brute.brute_sdf_bytes(b, ATLAS_SPREAD).numpy()
    elif pipeline == "jfa":
        want = jfa.jfa_distance(b[0]).numpy()
    elif pipeline == "soft":
        want = sharded.sharded_soft_sdf_field(torch.from_numpy(imgs[..., 1]), ATLAS_SPREAD,
                                              make_mesh((2, 4), ("data", "y"), devices="cpu"), tau=TAU, temperature=T,
                                              batch_axis="data").numpy()
    for pid, w in enumerate(run["workers"]):
        assert w["local_part"].tolist() == [2, 32, 24] and w["local_mesh"].tolist() == [1, 4]
        assert not bool(w["local_spans"])
        got = w[f"direct_{pipeline}"]
        if pipeline == "hard":
            np.testing.assert_array_equal(got, w["atlas_y4"])
        elif pipeline == "jfa":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(got, want[2 * pid : 2 * pid + 2])


def test_train_steps_match_jax(run):
    """Two Adam steps, 'data' over the processes and 'y' over 2 shards of
    each: the global loss within 1e-4 relative and the parameters within
    1e-4 of JAX's jitted make_train_step on the whole batch
    (tests/test_torch_soft_model.py:151-171's tolerances); the same
    parameters in both processes."""
    j_losses, j_params = run["jax_steps"]
    w0, w1 = run["workers"]
    np.testing.assert_array_equal(w0["params"], w1["params"])
    np.testing.assert_array_equal(w0["losses"], w1["losses"])
    np.testing.assert_allclose(w0["losses"], j_losses, rtol=1e-4, atol=0)
    np.testing.assert_allclose(w0["params"], j_params, atol=1e-4, rtol=0)
    assert w0["losses"][1] < w0["losses"][0]


@pytest.mark.parametrize("layout", ["mesh (2, 2)", "one device"])
def test_train_steps_match_one_process(run, layout):
    """The same steps in one process on the whole batch, over a (2, 2)
    ('data', 'y') mesh of logical shards and on one device: losses within
    1e-6 relative, parameters within 1e-5 of their scale (chip_smoke.py
    phase 28's tolerances)."""
    _, losses, params = run["mesh_steps" if layout.startswith("mesh") else "device_steps"]
    w = run["workers"][0]
    np.testing.assert_allclose(w["losses"], losses, rtol=1e-6, atol=0)
    np.testing.assert_allclose(w["params"], params, atol=1e-5 * max(np.abs(params).max(), 1.0), rtol=0)


def test_forward_returns_own_rows(run):
    """SoftSDFModel over the global mesh returns this process's rows of the
    field: the one-process model's over a (2, 2) mesh at those rows, bit
    for bit (the same tier on the same shards)."""
    want = run["mesh_steps"][0]
    for pid, w in enumerate(run["workers"]):
        assert w["field_index"].tolist() == [pid, pid + 1]
        np.testing.assert_array_equal(w["field"], want[pid : pid + 1])


def test_checkpoint_written_once_and_restored(run):
    """save_train_state in both processes: process 0 writes the one file,
    both see it on return and restore the trained parameters; the parent
    restores it too."""
    w0, w1 = run["workers"]
    assert (int(w0["saves"]), int(w1["saves"])) == (1, 0)
    for w in (w0, w1):
        assert bool(w["ckpt_seen"]) and int(w["ckpt_step"]) == 2
        np.testing.assert_array_equal(w["ckpt_params"], w["params"][-1])
    params, opt_state, step = checkpoint.restore_train_state(os.path.join(run["tmp"], "ckpt", "state.pt"))
    assert step == 2 and set(opt_state) == {"state", "param_groups"}
    np.testing.assert_array_equal(_flat(params[k] for k in PARAM_NAMES), w0["params"][-1])


@pytest.mark.parametrize("name", ["atlas", "sharded", "soft", "model"])
def test_crossing_y_line_matches(run, name):
    """The (1, 8) ('data', 'y') mesh whose 'y' line crosses the processes
    (4 shards of 4 rows each; EXACT's band of 8 takes two hops, one across
    them): each process's rows of all 4 images. The atlas and the hard
    pipeline byte for byte JAX's hard_sdf_exact; the soft field (the
    composed tier) and the model's forward within 1e-5 of JAX's over a
    (1, 8) mesh (tests/test_torch_sharded_soft.py's field tolerance) and
    bit for bit the port over a (1, 8) logical mesh in one process."""
    imgs = run["imgs"]
    x = torch.from_numpy(imgs)
    for pid, w in enumerate(run["workers"]):
        index = tuple(slice(a, b) for a, b in w["cross_index"])
        assert [(s.start, s.stop) for s in index] == [(0, 4), (16 * pid, 16 * pid + 16), (0, 24)]
        got = w[f"cross_{name}"]
        if name in ("atlas", "sharded"):
            np.testing.assert_array_equal(got, run["atlas"][index])
            continue
        m = make_mesh((1, 8), ("data", "y"), devices="cpu")
        with torch.no_grad():
            if name == "soft":
                want = sharded.sharded_soft_sdf_field(threshold.hard_threshold(x).float(), ATLAS_SPREAD, m,
                                                      batch_axis="data")
            else:
                want = soft_model.SoftSDFModel(SPREAD, mesh=m, batch_axis="data")(torch.from_numpy(run["img2ch"]))
        index = index if name == "soft" else (slice(0, 2), index[1], slice(None))
        np.testing.assert_allclose(got, run["jax_line"][name][index], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got, want.numpy()[index])


def test_crossing_meshes_layout(run):
    """make_mesh((4,)) and ShardingConfig((4,)).build_mesh in the run: every
    process's 2 logical shards in rank order, processes [0, 0, 1, 1], each
    process's rows its half, as spanning_mesh over each process's list of
    2; make_mesh over a list of this process's devices stays this
    process's; the 'x' line and the model's mesh likewise."""
    for pid, w in enumerate(run["workers"]):
        assert w["y_processes"].tolist() == [0, 0, 1, 1] and w["built_processes"].tolist() == [0, 0, 1, 1]
        assert w["spanning_processes"].tolist() == [0, 0, 1, 1]
        assert w["own_processes"].tolist() == [pid] * 4 and not bool(w["own_spans"])
        assert w["y_index"].tolist() == [[32 * pid, 32 * pid + 32], [0, 48]]
        assert w["x_index"].tolist() == [[0, 64], [24 * pid, 24 * pid + 24]]
        assert w["model_processes"].tolist() == [[0, 1], [0, 1]]
        assert w["model_index"].tolist() == [[0, 2], [16 * pid, 16 * pid + 16], [0, 32]]
        exchanges, legs, nbytes = w["legs"].tolist()
        assert exchanges > 0 and legs >= exchanges and nbytes > 0


@pytest.mark.parametrize("halo_impl", HALOS)
@pytest.mark.parametrize("pipeline", [f"hard_{s}" for s in HARD_SPREADS] + [f"brute_{s}" for s in BRUTE_SPREADS])
def test_hard_across_processes_match_jax(run, pipeline, halo_impl):
    """Sharded EXACT (one hop, two hops with band 22 over 16-row shards,
    uint16 strips at spread 300) and BRUTE over the (4,) 'y' mesh across
    the processes: each process's rows byte for byte JAX's sharded
    pipeline over a (4,) mesh, under both halo forms."""
    want = run["jax_cross"][pipeline]
    for pid, w in enumerate(run["workers"]):
        np.testing.assert_array_equal(w[f"y_{pipeline.replace('_', f'_{halo_impl}_', 1)}"],
                                      want[32 * pid : 32 * pid + 32])


@pytest.mark.parametrize("pipeline", ["y_jfa", "x_jfa", "x_hard_ppermute", "x_hard_rdma", "x_brute_ppermute",
                                      "x_brute_rdma"])
def test_jfa_and_x_line_across_processes_match_jax(run, pipeline):
    """Sharded JFA over the (4,) 'y' mesh (strides up to 32 over 16-row
    shards: slabs across the processes, two hops) bit for bit JAX's sharded
    JFA; over the ('x', 'y') (2, 2) mesh whose 'x' lines cross the
    processes, JFA, EXACT at spread 20 and BRUTE at 6 (column halos of codes
    across them) byte for byte JAX's single-device pipelines."""
    ref = run["jax_cross"]["jfa" if pipeline == "y_jfa" else "_".join(pipeline.split("_")[:2])]
    for pid, w in enumerate(run["workers"]):
        index = (slice(32 * pid, 32 * pid + 32),) if pipeline == "y_jfa" else (slice(None), slice(24 * pid, 24 * pid + 24))
        np.testing.assert_array_equal(w[pipeline], ref[index])


@pytest.mark.parametrize("halo_impl", HALOS)
@pytest.mark.parametrize("case", list(SOFT_CASES))
def test_soft_tiers_across_processes(run, case, halo_impl):
    """The soft tiers over the (4,) 'y' mesh across the processes (1a: the
    declared kernels on 128-row shards; 2: the adaptive kernels, split; 3:
    the composed scan), each process's rows of the field and of the
    gradient of sum(w * field), w a random cotangent zeroed at knee
    outputs: the field within JAX's tolerances (1e-4 for 1a, 1e-5 else,
    tests/test_torch_sharded_soft.py) and the gradient within 1e-4 of the
    scale of JAX's (tier 2 against JAX's float32 composed tier, as there);
    the field bit for bit and the gradient within 1e-6 of the scale of the
    port's one-process (4,) mesh."""
    f_j, g_j = run["jax_cross"][f"soft_{case}"]
    f_p, g_p = run["port_cross"][f"soft_{case}"]
    scale = np.abs(g_j).max()
    for w in run["workers"]:
        rows = slice(*w[f"soft_{case}_index"])
        field, grad = w[f"soft_{case}_{halo_impl}"], w[f"soft_{case}_{halo_impl}_grad"][rows]
        np.testing.assert_allclose(field, f_j[rows], atol=1e-4 if case == "1a" else 1e-5, rtol=1e-5)
        np.testing.assert_allclose(grad, g_j[rows], atol=1e-4 * scale, rtol=0)
        np.testing.assert_array_equal(field, f_p[rows])
        np.testing.assert_allclose(grad, g_p[rows], atol=1e-6 * np.abs(g_p).max(), rtol=0)
        other = np.ones(g_p.shape[0], bool)
        other[rows] = False
        assert not w[f"soft_{case}_{halo_impl}_grad"][other].any()  # the other process's rows take nothing here


def test_soft_tier_1a_on_an_x_line_across_processes(run):
    """Tier 1a over the ('x', 'y') (2, 2) mesh whose 'x' lines cross the
    processes (the k1-column gray halo across them), under rdma: each
    process's columns of the field within 1e-4 and of the gradient within
    1e-4 of the scale of JAX's sharded tier 1a over a (2, 2) ('x', 'y')
    mesh (tests/test_torch_sharded_soft.py's tolerances); the field bit
    for bit the port's one-process mesh, the gradient within 1e-6 of the
    scale (the column exchange's VJP adds the x-boundary gradient in its
    own order)."""
    f_j, g_j = run["jax_cross"]["soft_2d"]
    f_p, g_p = run["port_cross"]["soft_2d"]
    for pid, w in enumerate(run["workers"]):
        cols = slice(128 * pid, 128 * pid + 128)
        np.testing.assert_allclose(w["soft_2d"], f_j[:, cols], atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(w["soft_2d_grad"][:, cols], g_j[:, cols], atol=1e-4 * np.abs(g_j).max(), rtol=0)
        np.testing.assert_array_equal(w["soft_2d"], f_p[:, cols])
        np.testing.assert_allclose(w["soft_2d_grad"][:, cols], g_p[:, cols], atol=1e-6 * np.abs(g_p).max(), rtol=0)


@pytest.mark.parametrize("algo", ["exact", "brute", "jfa", "soft"])
def test_sdf_generator_across_processes(run, algo):
    """SDFGenerator(sharding=ShardingConfig((4,)), device="cpu") in each
    process of the run: its mesh crosses them, and generate (EXACT, BRUTE,
    JFA) and generate_field (the soft field under rdma, tier 2 on 16-row
    shards) return its rows at own_index, byte for byte the unsharded
    SDFGenerator's (the soft field within 1e-5 of it and of JAX's
    SDFGenerator over a (4,) mesh, tests/test_torch_sharded_soft.py's
    field tolerance)."""
    img = run["cross"]["image"]
    if algo == "soft":
        want = SDFGenerator(SdfConfig(spread=6), soft=SoftConfig(tau=SOFT_TAU, temperature=1.0),
                            device="cpu").generate_field(img).numpy()
    else:
        want = SDFGenerator(SdfConfig(spread=6, algorithm=Algorithm(algo)), device="cpu").generate(img).numpy()
    for pid, w in enumerate(run["workers"]):
        assert w["gen_index"].tolist() == [[32 * pid, 32 * pid + 32], [0, 48]]
        got = w[f"gen_{algo}"]
        if algo == "soft":
            np.testing.assert_allclose(got, want[32 * pid : 32 * pid + 32], atol=1e-5, rtol=0)
            np.testing.assert_allclose(got, run["jax_cross"]["gen_soft"][32 * pid : 32 * pid + 32], atol=1e-5,
                                       rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, want[32 * pid : 32 * pid + 32])


def test_train_steps_with_y_across_processes(run):
    """SoftSDFModel over ('data', 'y') (2, 2) with processes [[0, 1], [0,
    1]]: each process its rows of both images, the halos across the
    processes both ways; two Adam steps within test_train_steps_match_jax's
    bounds of JAX's and within 1e-6 relative (losses) and 1e-5 (parameters)
    of the one-process (2, 2) mesh; the same in both processes."""
    j_losses, j_params = run["jax_steps"]
    _, losses, params = run["mesh_steps"]
    w0, w1 = run["workers"]
    np.testing.assert_array_equal(w0["y_params"], w1["y_params"])
    np.testing.assert_array_equal(w0["y_losses"], w1["y_losses"])
    np.testing.assert_allclose(w0["y_losses"], j_losses, rtol=1e-4, atol=0)
    np.testing.assert_allclose(w0["y_params"], j_params, atol=1e-4, rtol=0)
    np.testing.assert_allclose(w0["y_losses"], losses, rtol=1e-6, atol=0)
    np.testing.assert_allclose(w0["y_params"], params, atol=1e-5 * max(np.abs(params).max(), 1.0), rtol=0)


@pytest.mark.parametrize("name", ["model_unbatched", "counts", "no_block"])
def test_refusals(run, name):
    """A model over the global mesh with no batch axis raises (its 'data'
    axis crosses the processes: every process would compute every row, and
    the summed loss and gradients would be the process count times the
    mean's); unequal device counts raise in global_mesh; a process whose
    entries form no block of the mesh raises; in both processes."""
    for w in run["workers"]:
        msg = str(w[f"refused_{name}"])
        if name == "counts":
            assert "unequal device counts [4, 2]" in msg
        elif name == "model_unbatched":
            assert "mesh axis 'data' crosses processes" in msg and "batch_axis=None" in msg
        else:
            assert "form no block of the mesh" in msg and "[[0, 1], [1, 0]]" in msg
