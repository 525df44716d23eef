"""The PyTorch port as a whole, on the CPU. The hard EXACT slice: the
pipeline functions and SDFGenerator against the JAX package and the NumPy
oracle of the reference binary, and the CLI end to end against the JAX
package's CLI on the same PNG, byte-exact. The soft slice: SDFGenerator's
field and bytes and the CLI's --soft against the JAX package's, within the
soft path's tolerances. The BRUTE and JFA pipelines through SDFGenerator
and the CLI, byte-exact against the JAX package's. And the refusal to run
on the CPU unasked."""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import chaq_sdfgen_tpu.cli as jcli
import chaq_sdfgen_tpu.config as jcfg
from chaq_sdfgen_tpu.ops import merge as jmerge
from chaq_sdfgen_tpu.ops import pallas_soft_mm as jpm
from chaq_sdfgen_tpu.models import sdf_model as jmodel
from sdfref import oracle

import chaq_sdfgen_tpu_torch.cli as tcli
import chaq_sdfgen_tpu_torch.config as tcfg
from chaq_sdfgen_tpu_torch.models import sdf_model as tmodel


def _image(shape=(41, 57), seed=0):
    """Gray+alpha image: a disc and a bar in alpha, noise in gray."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    alpha = np.where((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2, 230, 10)
    alpha[h // 5 : h // 5 + 3, w // 2 :] = 200
    alpha = (alpha + rng.integers(-8, 9, size=shape)).clip(0, 255)
    gray = rng.integers(0, 256, size=shape)
    return np.stack([gray, alpha], -1).astype(np.uint8)


FLAGS = [
    # (spread, asymmetric, channel, test_above)  ~ -s, -a, -l, -n
    (64, False, 1, True),
    (10, True, 1, True),
    (10, False, 0, True),
    (10, False, 1, False),
    (100, True, 0, True),
]


@pytest.mark.parametrize("spread,asymmetric,channel,test_above", FLAGS)
def test_hard_sdf_exact_matches_jax_and_oracle(spread, asymmetric, channel, test_above):
    img = _image(seed=spread)
    kw = dict(spread=spread, asymmetric=asymmetric, channel=channel, test_above=test_above)
    got = tmodel.hard_sdf_exact(torch.from_numpy(img), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmodel.hard_sdf_exact(jnp.asarray(img), **kw)))
    np.testing.assert_array_equal(got, oracle.sdf_pipeline_openmp(img, **kw))


def test_hard_sdf_exact_from_bool_matches_jax():
    b = np.random.default_rng(1).random((2, 20, 31)) < 0.4
    want = jmodel.hard_sdf_exact_from_bool(jnp.asarray(b), 7)
    got = tmodel.hard_sdf_exact_from_bool(torch.from_numpy(b), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"spread": 100, "asymmetric": True, "channel": "luminance"},
        {"spread": 9, "invert": True},
        {"spread": 300},
    ],
)
def test_sdf_generator_matches_jax(kw):
    jc = jcfg.SdfConfig(**kw)
    tc = tcfg.SdfConfig.from_dict(dataclasses.asdict(jc))
    img = _image(seed=len(kw))
    gen = tmodel.SDFGenerator(tc, device="cpu")
    want = np.asarray(jmodel.SDFGenerator(jc).generate(img))
    got = gen.generate(img)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        oracle.sdf_pipeline_openmp(img, tc.spread, tc.asymmetric, tc.channel_offset, not tc.invert),
    )
    batch = np.stack([img, _image(seed=5)])
    np.testing.assert_array_equal(gen.generate(torch.from_numpy(batch))[0].numpy(), want)


@pytest.mark.parametrize(
    "kw",
    [
        {"algorithm": "brute"},
        {"algorithm": "brute", "spread": 9, "asymmetric": True, "channel": "luminance"},
        {"algorithm": "brute", "spread": 7, "invert": True},
        {"algorithm": "brute", "spread": 300},
        {"algorithm": "jfa"},
        {"algorithm": "jfa", "spread": 12, "asymmetric": True, "channel": "luminance"},
        {"algorithm": "jfa", "spread": 9, "invert": True, "jfa_plus_one": False},
    ],
)
def test_sdf_generator_brute_and_jfa_match_jax(kw):
    """SDFGenerator's BRUTE and JFA pipelines (-l, -n, -a) against the JAX
    SDFGenerator's bytes, on an image and a batch of 2; BRUTE also against
    the NumPy oracle of the OpenCL binary."""
    jc = jcfg.SdfConfig(**kw)
    tc = tcfg.SdfConfig.from_dict(dataclasses.asdict(jc))
    img = _image(seed=len(kw))
    gen = tmodel.SDFGenerator(tc, device="cpu")
    want = np.asarray(jmodel.SDFGenerator(jc).generate(img))
    got = gen.generate(img)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if tc.algorithm == tcfg.Algorithm.BRUTE:
        np.testing.assert_array_equal(
            got.numpy(),
            oracle.sdf_pipeline_opencl(img, tc.spread, tc.asymmetric, tc.channel_offset == 0, tc.invert),
        )
    batch = np.stack([img, _image(seed=5)])
    np.testing.assert_array_equal(gen.generate(torch.from_numpy(batch))[0].numpy(), want)


def test_sdf_generator_refuses_unported_paths():
    """Nothing is refused now. SDFGenerator at spread 111 (band 113, past
    the adaptive kernels: the composed path) with an undeclared and an
    out-of-gamut range: field within 1e-4 of the JAX SDFGenerator's
    generate_field (its CPU composed path); with a sharding (the sharded
    composed tier over 2 shards), the same field as without."""
    img = _image(shape=(30, 34), seed=2)
    want = np.asarray(jmodel.SDFGenerator(jcfg.SdfConfig(spread=111), soft=jcfg.SoftConfig()).generate_field(img))
    for rng in (None, (-1e9, 1e9)):
        tmodel.SDFGenerator(soft=tcfg.SoftConfig(gray_range=rng), device="cpu")
        gen = tmodel.SDFGenerator(tcfg.SdfConfig(spread=111), soft=tcfg.SoftConfig(gray_range=rng), device="cpu")
        np.testing.assert_allclose(gen.generate_field(img).numpy(), want, atol=1e-4, rtol=0)
    sharded = tmodel.SDFGenerator(tcfg.SdfConfig(spread=111), soft=tcfg.SoftConfig(gray_range=None),
                                  sharding=tcfg.ShardingConfig((2,)), device="cpu")
    np.testing.assert_array_equal(sharded.generate_field(img).numpy(), gen.generate_field(img).numpy())
    with pytest.raises(ValueError):
        tmodel.SDFGenerator(device="cpu").generate(np.zeros((4, 4, 3), np.uint8))


def test_kernel_time_on_cpu_is_positive():
    t = tmodel.SDFGenerator(device="cpu").kernel_time(_image(), iters=2)
    assert 0 < t < 60


def test_kernel_time_takes_the_jax_two_count_slope():
    """kernel_time(img2ch, k1=4, k2=36) as in the JAX package: the slope
    between k1 and k2 back-to-back runs, by keyword or by position; iters=
    keeps the median of single runs; k2 <= k1 is refused."""
    import inspect

    want = {n: p.default for n, p in inspect.signature(jmodel.SDFGenerator.kernel_time).parameters.items()
            if n in ("k1", "k2")}
    got = inspect.signature(tmodel.SDFGenerator.kernel_time).parameters
    assert {n: got[n].default for n in want} == want == {"k1": 4, "k2": 36}
    gen = tmodel.SDFGenerator(device="cpu")
    for t in (gen.kernel_time(_image(), k1=1, k2=3), gen.kernel_time(_image(), 1, 3)):
        assert isinstance(t, float) and np.isfinite(t) and 0 < t < 60
    assert 0 < gen.kernel_time(_image(), iters=2) < 60
    with pytest.raises(ValueError):
        gen.kernel_time(_image(), k1=3, k2=3)


@pytest.fixture(scope="module")
def input_png(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "in.png"
    Image.fromarray(_image(shape=(48, 64), seed=3), mode="LA").save(path)
    return str(path)


def _decode(path_or_bytes):
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    im = Image.open(src)
    return im.mode, np.asarray(im)


@pytest.mark.parametrize(
    "flags",
    [[], ["-al"], ["-s", "100"], ["-n", "-s", "7"], ["-l", "-s", "3", "--two-channel"],
     ["-s", "20", "-f", "bmp"], ["--algorithm", "brute", "-al"],
     ["--algorithm", "brute", "-n", "-s", "7", "--two-channel"], ["--algorithm", "jfa", "-s", "20"],
     ["--algorithm", "jfa", "-aln"]],
)
def test_cli_matches_jax_cli(tmp_path, input_png, flags):
    ext = "bmp" if "bmp" in flags else "png"
    t_out, j_out = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    assert tcli.main(["-i", input_png, "-o", str(t_out), "--platform", "cpu", *flags]) == 0
    assert jcli.main(["-i", input_png, "-o", str(j_out), *flags]) == 0
    t_mode, t_px = _decode(str(t_out))
    j_mode, j_px = _decode(str(j_out))
    assert t_mode == j_mode
    np.testing.assert_array_equal(t_px, j_px)


def test_cli_stdout_streaming_matches_jax(input_png, capsysbinary):
    assert tcli.main(["-i", input_png, "-o", "-", "-s", "100", "-al", "--platform", "cpu"]) == 0
    t_data = capsysbinary.readouterr().out
    assert jcli.main(["-i", input_png, "-o", "-", "-s", "100", "-al"]) == 0
    j_data = capsysbinary.readouterr().out
    np.testing.assert_array_equal(_decode(t_data)[1], _decode(j_data)[1])


def test_cli_brute_stdout_streaming_matches_jax(input_png, capsysbinary):
    flags = ["-o", "-", "-s", "100", "-al", "--algorithm", "brute", "--two-channel"]
    assert tcli.main(["-i", input_png, *flags, "--platform", "cpu"]) == 0
    t_data = capsysbinary.readouterr().out
    assert jcli.main(["-i", input_png, *flags]) == 0
    j_data = capsysbinary.readouterr().out
    assert _decode(t_data)[0] == _decode(j_data)[0] == "LA"
    np.testing.assert_array_equal(_decode(t_data)[1], _decode(j_data)[1])


def test_cli_validation_errors(tmp_path, input_png):
    out = str(tmp_path / "x.png")
    cpu = ["--platform", "cpu"]
    assert tcli.main(["-i", input_png, "-s", "10", *cpu]) == 1  # no output
    assert tcli.main(["-o", out, *cpu]) == 1  # no input
    assert tcli.main(["-i", input_png, "-o", out, "-q", "0", *cpu]) == 1
    assert tcli.main(["-i", input_png, "-o", out, "-q", "101", *cpu]) == 1
    assert tcli.main(["-i", input_png, "-o", out, "-s", "0", *cpu]) == 1
    assert tcli.main(["-i", "/nonexistent.png", "-o", out, *cpu]) == 1
    assert tcli.main(["-i", input_png, "-o", out, "-f", "webp", *cpu]) == 1
    assert tcli.main(["-i", input_png, "-o", out, "--soft-field", str(tmp_path / "f.npy"), *cpu]) == 1
    assert not os.path.exists(out)


def test_cli_platforms_and_devices(tmp_path, input_png, capsys):
    assert tcli.main(["--list-platforms"]) == 0
    assert "cpu" in capsys.readouterr().out
    assert tcli.main(["--platform", "CP", "--list-devices"]) == 0
    assert "0: cpu (cpu)" in capsys.readouterr().out
    out = tmp_path / "dev.png"
    assert tcli.main(["-i", input_png, "-o", str(out), "--platform", "cpu", "--device", "0"]) == 0
    assert tcli.main(["-i", input_png, "-o", str(out), "--platform", "vulkan"]) == 1
    assert "Platform specified not found." in capsys.readouterr().err
    assert tcli.main(["-i", input_png, "-o", str(out), "--platform", "cpu", "--device", "9"]) == 1
    assert tcli.main(["-i", input_png, "-o", str(out), "--device", "no-such-card"]) == 1


def test_cli_accepts_and_ignores_no_jit_cache(tmp_path, input_png):
    """--no-jit-cache, the JAX CLI's hidden switch, is accepted by both CLIs
    and changes none of the port's output bytes."""
    assert jcli.build_parser().parse_args(["-i", "a", "-o", "b", "--no-jit-cache"]).no_jit_cache
    assert "--no-jit-cache" not in tcli.build_parser().format_help()
    outs = []
    for extra in ([], ["--no-jit-cache"]):
        out = tmp_path / f"o{len(extra)}.png"
        assert tcli.main(["-i", input_png, "-o", str(out), "--platform", "cpu", *extra]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_cli_time_flag(tmp_path, input_png, capsys):
    assert tcli.main(["-i", input_png, "-o", str(tmp_path / "t.png"), "--platform", "cpu", "--time"]) == 0
    err = capsys.readouterr().err
    assert "Kernel timing:" in err and "sec" in err


def test_import_pulls_in_no_jax():
    code = (
        "import sys, chaq_sdfgen_tpu_torch, chaq_sdfgen_tpu_torch.cli, "
        "chaq_sdfgen_tpu_torch.ops.cuda_edt, chaq_sdfgen_tpu_torch.utils.imageio, "
        "chaq_sdfgen_tpu_torch.ops.cuda_soft_mm, chaq_sdfgen_tpu_torch.ops.soft_mxu, "
        "chaq_sdfgen_tpu_torch.ops.softsdf, chaq_sdfgen_tpu_torch.ops.cuda_brute, "
        "chaq_sdfgen_tpu_torch.ops.brute, chaq_sdfgen_tpu_torch.ops.jfa, chaq_sdfgen_tpu_torch.ops.softmin; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'chaq_sdfgen_tpu.'))"
        " or m == 'chaq_sdfgen_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_module_imports_with_jax_blocked():
    """Every module of the port, and chip_smoke.py, imports with jax and
    chaq_sdfgen_tpu blocked in sys.modules (an import of either raises)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'chaq_sdfgen_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import chaq_sdfgen_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "sys.argv = ['chaq_sdfgen_tpu_torch', '--list-platforms']  # __main__ runs the CLI\n"
        "for n in names + ['chip_smoke']:\n"
        "    try:\n"
        "        importlib.import_module(n)\n"
        "    except SystemExit as e:\n"
        "        assert n.endswith('__main__') and e.code == 0, (n, e.code)\n"
        "print(len(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[-1]) >= 20


# ------------------------------------------------------------- soft slice


def _soft_pair(kw, soft_kw):
    jc, js = jcfg.SdfConfig(**kw), jcfg.SoftConfig(**soft_kw)
    tc = tcfg.SdfConfig.from_dict(dataclasses.asdict(jc))
    ts = tcfg.SoftConfig.from_dict(dataclasses.asdict(js))
    return jmodel.SDFGenerator(jc, soft=js), tmodel.SDFGenerator(tc, soft=ts, device="cpu")


@pytest.mark.parametrize(
    "kw,soft_kw",
    [({"spread": 16}, {"tau": 2.0, "temperature": 1.0}),
     ({"spread": 12, "asymmetric": True, "invert": True}, {"tau": 2.0, "temperature": 1.0}),
     ({"spread": 10, "channel": "luminance"}, {"clamp": "tanh", "tau": 4.0, "temperature": 1.5})],
)
def test_soft_generator_matches_jax(kw, soft_kw):
    """Field within 2e-3 of JAX's generate_field (which runs the composed
    path on the CPU), bytes within 1 of JAX's generate (a truncating cast
    of values within 2e-3 can land one byte apart), on an image and a
    batch of 2."""
    jgen, tgen = _soft_pair(kw, soft_kw)
    img = _image(shape=(40, 52), seed=7)
    field = tgen.generate_field(img)
    assert field.dtype == torch.float32 and field.shape == (40, 52)
    np.testing.assert_allclose(field.numpy(), np.asarray(jgen.generate_field(img)), atol=2e-3, rtol=0)
    got = tgen.generate(img)
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - np.asarray(jgen.generate(img)).astype(int))
    assert diff.max() <= 1
    batch = np.stack([img, _image(shape=(40, 52), seed=8)])
    bf = tgen.generate_field(torch.from_numpy(batch))
    assert bf.shape == (2, 40, 52)
    np.testing.assert_array_equal(bf[0].numpy(), field.numpy())
    np.testing.assert_array_equal(tgen.generate(batch)[0].numpy(), got.numpy())


def _jax_kernel_bytes(field, spread, asymmetric, clamp):
    v = jmerge.soft_remap(jnp.asarray(field), spread, asymmetric, clamp=clamp)
    return np.asarray(jnp.clip(v, 0.0, 255.0).astype(jnp.uint8))


@pytest.mark.parametrize("spread", [16, 64])
def test_soft_generator_defaults_match_jax_kernel(spread):
    """At the default tau 1 / T 0.5, against the JAX pair of kernels that
    JAX's SDFGenerator runs on its accelerator (pallas_soft_mm in interpret
    mode): field within 1e-4, bytes within 1. JAX's CPU composed path
    differs from those kernels here (ROADMAP Queue 3: taps at d >= 7
    underflow at T 0.5), so it is not the reference for these defaults."""
    img = _image(shape=(40, 52), seed=7)
    gen = tmodel.SDFGenerator(tcfg.SdfConfig(spread=spread), soft=tcfg.SoftConfig(), device="cpu")
    want = np.asarray(jpm.soft_field_mm_fused(jnp.asarray(img[..., 1].astype(np.float32)),
                                              spread + 2, 1.0, 0.5, 1e-6, interpret=True))
    field = gen.generate_field(img).numpy()
    np.testing.assert_allclose(field, want, atol=1e-4, rtol=0)
    diff = np.abs(gen.generate(img).numpy().astype(int)
                  - _jax_kernel_bytes(want, spread, False, "hard").astype(int))
    assert diff.max() <= 1


def test_soft_generator_field_needs_soft_and_times():
    with pytest.raises(ValueError):
        tmodel.SDFGenerator(device="cpu").generate_field(_image())
    gen = tmodel.SDFGenerator(tcfg.SdfConfig(spread=8), soft=tcfg.SoftConfig(), device="cpu")
    assert 0 < gen.kernel_time(_image(), iters=2) < 60


def test_cli_soft_matches_jax_cli(tmp_path, input_png):
    """--soft with --soft-field against the JAX CLI at tau 2 / T 1 (where
    the JAX CLI's CPU composed path and the kernels agree): bytes within
    1, field within 2e-3."""
    t_out, j_out = tmp_path / "t.png", tmp_path / "j.png"
    t_f, j_f = tmp_path / "t.npy", tmp_path / "j.npy"
    flags = ["--soft", "-s", "12", "--soft-tau", "2", "--soft-temperature", "1"]
    assert tcli.main(["-i", input_png, "-o", str(t_out), "--soft-field", str(t_f),
                      "--platform", "cpu", *flags]) == 0
    assert jcli.main(["-i", input_png, "-o", str(j_out), "--soft-field", str(j_f), *flags]) == 0
    t_px, j_px = _decode(str(t_out))[1], _decode(str(j_out))[1]
    assert np.abs(t_px.astype(int) - j_px.astype(int)).max() <= 1
    np.testing.assert_allclose(np.load(t_f), np.load(j_f), atol=2e-3, rtol=0)


def test_cli_soft_defaults_match_jax_kernel(tmp_path, input_png):
    """--soft at its defaults (tau 1, T 0.5, spread 64) against the JAX
    kernels the JAX CLI runs on its accelerator: field within 1e-4,
    bytes within 1."""
    out, f = tmp_path / "t.png", tmp_path / "t.npy"
    assert tcli.main(["-i", input_png, "-o", str(out), "--soft", "--soft-field", str(f),
                      "--platform", "cpu"]) == 0
    gray = _decode(input_png)[1][..., 1].astype(np.float32)
    want = np.asarray(jpm.soft_field_mm_fused(jnp.asarray(gray), 66, 1.0, 0.5, 1e-6, interpret=True))
    np.testing.assert_allclose(np.load(f), want, atol=1e-4, rtol=0)
    px = _decode(str(out))[1]
    assert np.abs(px.astype(int) - _jax_kernel_bytes(want, 64, False, "hard").astype(int)).max() <= 1


def test_cli_soft_refuses_undeclared_range(tmp_path, input_png):
    """An undeclared range runs at every spread: the runtime-gated path up
    to band 112, the composed path above it. At -s 111 against the JAX CLI
    (its CPU composed path): bytes within 1, field within 1e-4."""
    t_out, j_out = tmp_path / "t.png", tmp_path / "j.png"
    t_f, j_f = tmp_path / "t.npy", tmp_path / "j.npy"
    flags = ["--soft", "--gray-range", "-1e9", "1e9", "-s", "111"]
    assert tcli.main(["-i", input_png, "-o", str(t_out), "--soft-field", str(t_f), "--platform", "cpu",
                      *flags]) == 0
    assert jcli.main(["-i", input_png, "-o", str(j_out), "--soft-field", str(j_f), *flags]) == 0
    np.testing.assert_allclose(np.load(t_f), np.load(j_f), atol=1e-4, rtol=0)
    t_px, j_px = _decode(str(t_out))[1], _decode(str(j_out))[1]
    assert np.abs(t_px.astype(int) - j_px.astype(int)).max() <= 1
    out = str(tmp_path / "o.png")
    assert tcli.main(["-i", input_png, "-o", out, "--soft", "--gray-range", "-1e9", "1e9",
                      "--platform", "cpu", "-s", "12"]) == 0
    assert os.path.exists(out)


@pytest.mark.parametrize("flags", [["-s", "1073741822"], ["--algorithm", "brute", "-s", "32767"]])
def test_cli_refused_spread_is_one_line(tmp_path, input_png, flags, capsys):
    """A spread the kernels refuse (EXACT band above MAX_BAND = 2^30 - 1,
    BRUTE spread above 32766) ends the CLI with exit 1 and one line on
    stderr, no traceback, and writes nothing."""
    out = str(tmp_path / "o.png")
    assert tcli.main(["-i", input_png, "-o", out, "--platform", "cpu", *flags]) == 1
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "Traceback" not in err and "spread" in err
    assert not os.path.exists(out)


def test_no_card_needs_an_explicit_cpu(tmp_path, input_png, monkeypatch, capsys):
    """Without a card the port never carries on on the CPU by itself:
    SDFGenerator() raises and the CLI exits 1 unless the CPU is asked
    for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmodel.SDFGenerator()
    with pytest.raises(RuntimeError):
        tmodel.SDFGenerator(soft=tcfg.SoftConfig())
    for algorithm in ("brute", "jfa"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodel.SDFGenerator(tcfg.SdfConfig(algorithm=algorithm))
    out = str(tmp_path / "o.png")
    assert tcli.main(["-i", input_png, "-o", out]) == 1
    assert "--platform cpu" in capsys.readouterr().err
    assert not os.path.exists(out)
    assert tcli.main(["-i", input_png, "-o", out, "--platform", "cpu"]) == 0
