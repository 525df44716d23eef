"""The port's multi-host tier on the CPU: two processes joined by
``distributed.initialize`` (torch.distributed over gloo), the ('data', 'y')
``global_mesh`` across them, ``atlas_sdf`` and the ``SoftSDFModel`` Adam
step with the batch split over the processes, a checkpoint written once,
and the refusal of a 'y' line that crosses processes.

The parent spawns the two workers once (this file, run as a script: it
imports torch, numpy and the port, never JAX), each over 4 logical CPU
devices as tests/dcn_worker.py's processes hold 4 virtual ones. They write
what they computed to .npz files, which the tests hold against the JAX
package (hard_sdf_exact byte for byte; the flax model's jitted optax step)
and against the port in one process."""

import os
import sys

import numpy as np

ATLAS_SPREAD = 6
SPREAD, TAU, T, LR = 6, 20.0, 1.0, 5e-2
PARAM_NAMES = ("threshold_bias", "log_tau", "channel_mix")


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
    part, local = localize(b, mesh, ("data", "y", None), along=("y",))
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

    # refusals: a 'y' line across the processes, and unequal device counts
    g = distributed.global_mesh(devices=["cpu"] * 4)
    cross = Mesh(g.devices.reshape(1, 8), ("data", "y"), g.processes.reshape(1, 8), g.process)
    for name, fn in (("atlas", lambda: atlas.atlas_sdf(imgs, cfg, mesh=cross)),
                     ("sharded", lambda: sharded.sharded_hard_sdf_bytes(b, ATLAS_SPREAD, cross, batch_axis="data")),
                     ("soft", lambda: sharded.sharded_soft_sdf_field(b.float(), ATLAS_SPREAD, cross, batch_axis="data")),
                     ("model", lambda: soft_model.SoftSDFModel(SPREAD, mesh=cross, batch_axis="data")(img2ch)),
                     ("model_unbatched", lambda: soft_model.SoftSDFModel(SPREAD, mesh=mesh)),
                     ("counts", lambda: distributed.global_mesh(devices=["cpu"] * (4 if pid == 0 else 2)))):
        try:
            fn()
            out[f"refused_{name}"] = ""
        except ValueError as e:
            out[f"refused_{name}"] = str(e)

    torch.distributed.destroy_process_group()
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "chaq_sdfgen_tpu") for m in sys.modules)
    np.savez(os.path.join(tmp, f"worker{pid}.npz"), **out)
    print(f"DIST_OK p{pid}", flush=True)


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
import chaq_sdfgen_tpu.models.soft_model as jsm  # noqa: E402
from chaq_sdfgen_tpu.models.sdf_model import hard_sdf_exact as j_hard_sdf_exact  # noqa: E402
from chaq_sdfgen_tpu.ops import edt as jedt  # noqa: E402
from chaq_sdfgen_tpu.ops import merge as jmerge  # noqa: E402
from chaq_sdfgen_tpu_torch.config import SoftConfig  # noqa: E402
from chaq_sdfgen_tpu_torch.models import checkpoint, soft_model  # noqa: E402
from chaq_sdfgen_tpu_torch.ops import cuda_brute, jfa, threshold  # noqa: E402
from chaq_sdfgen_tpu_torch.parallel import sharded  # noqa: E402
from chaq_sdfgen_tpu_torch.parallel.mesh import make_mesh  # noqa: E402


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
    np.savez(os.path.join(tmp, "inputs.npz"), atlas=imgs, img2ch=img2ch, target=target)
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
                    device_steps=_one_process(img2ch, target, None))
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
    return dict(tmp=tmp, imgs=imgs, workers=workers, **refs)


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


@pytest.mark.parametrize("name", ["atlas", "sharded", "soft", "model", "model_unbatched", "counts"])
def test_refusals(run, name):
    """A 'y' line across the processes raises ValueError naming the
    layout, in the atlas, the hard and soft pipelines and the model; a
    model over the global mesh with no batch axis raises (every process
    would compute every row, and the summed loss and gradients would be
    the process count times the mean's); unequal device counts raise in
    global_mesh, in both processes."""
    for w in run["workers"]:
        msg = str(w[f"refused_{name}"])
        if name == "counts":
            assert "unequal device counts [4, 2]" in msg
        elif name == "model_unbatched":
            assert "mesh axis 'data' crosses processes" in msg and "batch_axis=None" in msg
        else:
            assert "crosses processes" in msg and "[[0, 0, 0, 0, 1, 1, 1, 1]]" in msg
