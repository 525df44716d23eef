"""The hard EXACT slice of the PyTorch port as a whole, on the CPU: the
pipeline functions and SDFGenerator against the JAX package and the NumPy
oracle of the reference binary, and the CLI end to end against the JAX
package's CLI on the same PNG. Every comparison is byte-exact."""

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


def test_sdf_generator_refuses_unported_paths():
    with pytest.raises(NotImplementedError):
        tmodel.SDFGenerator(tcfg.SdfConfig(algorithm="brute"))
    with pytest.raises(NotImplementedError):
        tmodel.SDFGenerator(tcfg.SdfConfig(algorithm="jfa"))
    with pytest.raises(NotImplementedError):
        tmodel.SDFGenerator(soft=tcfg.SoftConfig())
    with pytest.raises(NotImplementedError):
        tmodel.SDFGenerator(sharding=tcfg.ShardingConfig())
    with pytest.raises(ValueError):
        tmodel.SDFGenerator(device="cpu").generate(np.zeros((4, 4, 3), np.uint8))


def test_kernel_time_on_cpu_is_positive():
    t = tmodel.SDFGenerator(device="cpu").kernel_time(_image(), iters=2)
    assert 0 < t < 60


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
     ["-s", "20", "-f", "bmp"]],
)
def test_cli_matches_jax_cli(tmp_path, input_png, flags):
    ext = "bmp" if "bmp" in flags else "png"
    t_out, j_out = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    assert tcli.main(["-i", input_png, "-o", str(t_out), *flags]) == 0
    assert jcli.main(["-i", input_png, "-o", str(j_out), *flags]) == 0
    t_mode, t_px = _decode(str(t_out))
    j_mode, j_px = _decode(str(j_out))
    assert t_mode == j_mode
    np.testing.assert_array_equal(t_px, j_px)


def test_cli_stdout_streaming_matches_jax(input_png, capsysbinary):
    assert tcli.main(["-i", input_png, "-o", "-", "-s", "100", "-al"]) == 0
    t_data = capsysbinary.readouterr().out
    assert jcli.main(["-i", input_png, "-o", "-", "-s", "100", "-al"]) == 0
    j_data = capsysbinary.readouterr().out
    np.testing.assert_array_equal(_decode(t_data)[1], _decode(j_data)[1])


def test_cli_validation_errors(tmp_path, input_png):
    out = str(tmp_path / "x.png")
    assert tcli.main(["-i", input_png, "-s", "10"]) == 1  # no output
    assert tcli.main(["-o", out]) == 1  # no input
    assert tcli.main(["-i", input_png, "-o", out, "-q", "0"]) == 1
    assert tcli.main(["-i", input_png, "-o", out, "-q", "101"]) == 1
    assert tcli.main(["-i", input_png, "-o", out, "-s", "0"]) == 1
    assert tcli.main(["-i", "/nonexistent.png", "-o", out]) == 1
    assert tcli.main(["-i", input_png, "-o", out, "-f", "webp"]) == 1


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


def test_cli_time_flag(tmp_path, input_png, capsys):
    assert tcli.main(["-i", input_png, "-o", str(tmp_path / "t.png"), "--platform", "cpu", "--time"]) == 0
    err = capsys.readouterr().err
    assert "Kernel timing:" in err and "sec" in err


def test_import_pulls_in_no_jax():
    code = (
        "import sys, chaq_sdfgen_tpu_torch, chaq_sdfgen_tpu_torch.cli, "
        "chaq_sdfgen_tpu_torch.ops.cuda_edt, chaq_sdfgen_tpu_torch.utils.imageio; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'chaq_sdfgen_tpu.'))"
        " or m == 'chaq_sdfgen_tpu']; print(bad); sys.exit(1 if bad else 0)"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root
    )
    assert res.returncode == 0, res.stdout + res.stderr
