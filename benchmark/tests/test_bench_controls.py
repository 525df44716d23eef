"""The comparison that decides ``correct`` can fail: at a size the CPU
holds, a sound run is correct, the control (the reference one precision
below the configuration's, in the program's place) fails the cell's limits,
and each fault a cell can have, planted under the timed path, makes the
run's ``correct`` false. The harness's look for a card is skipped (device
"cpu"); the rest of a run is driven as on the card."""

import io
import json
import os
import subprocess
import sys

import pytest
import torch

import chaq_sdfgen_tpu_torch
from chaq_sdfgen_tpu_torch import SDFGenerator, SoftSDFModel
from chaq_sdfgen_tpu_torch.models import atlas
from benchmark.harness import manifest, runner

SMALL_GLYPH = {"channels": {"alpha": {"cell": 64, "margin": 8}}}
SMALL = {
    "exact_s64.atlas_glyph": {"config": {"size": [128, 128]}, "traffic": SMALL_GLYPH, "spec": {"sample": 4}},
    "exact_s64.dense_single": {"config": {"size": [128, 128]}, "spec": {"sample": 4}},
    "soft_train_s64.glyph_u8": {"config": {"size": [64, 64]}, "traffic": SMALL_GLYPH},
    "soft_train_s64.glyph_pm2040": {"config": {"size": [64, 64]}, "traffic": SMALL_GLYPH},
}
SEED = 2**31 + 99


def _run(cell, seconds=0.2):
    return runner.run_cell(cell, SEED, seconds, False, "cpu", overrides=SMALL[cell], out=io.StringIO(),
                           preloaded=frozenset(sys.modules))


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell,kind", [("exact_s64.atlas_glyph", "control"),
                                       ("exact_s64.dense_single", "short_band"),
                                       ("soft_train_s64.glyph_u8", "control"),
                                       ("soft_train_s64.glyph_pm2040", "control"),
                                       ("soft_train_s64.glyph_u8", "half_batch"),
                                       ("soft_train_s64.glyph_pm2040", "half_batch"),
                                       ("soft_train_s64.glyph_u8", "unchanged")])
def test_the_control_and_faults_fail_the_limits(cell, kind):
    _, driver = runner.prepare(cell, SEED, "cpu", SMALL[cell], io.StringIO())
    assert not all(c.passes for c in driver.readings(kind))


def _alter_one_byte(fn):
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out.view(-1)[out.numel() // 3] ^= 1
        return out
    return broken


def _drop_half_the_stack(fn):
    def broken(images, *a, **k):
        out = fn(images[: images.shape[0] // 2], *a, **k)
        return torch.cat([out, torch.zeros_like(out)])
    return broken


def _unchanged_step(model, opt):
    def step(x, target):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(x) - target) ** 2)
        loss.backward()
        return loss.detach()
    return step


def _half_batch_step(make):
    def wrapped(model, opt):
        step = make(model, opt)
        return lambda x, target: step(x[: x.shape[0] // 2], target[: target.shape[0] // 2])
    return wrapped


def _field_altered(forward):
    return lambda self, x: forward(self, x) + 1.0


FAULTS = [
    ("exact_s64.atlas_glyph", "answer altered", lambda mp: mp.setattr(atlas, "atlas_sdf", _alter_one_byte(atlas.atlas_sdf))),
    ("exact_s64.atlas_glyph", "half the batch left out",
     lambda mp: mp.setattr(atlas, "atlas_sdf", _drop_half_the_stack(atlas.atlas_sdf))),
    ("exact_s64.dense_single", "answer altered",
     lambda mp: mp.setattr(SDFGenerator, "generate", _alter_one_byte(SDFGenerator.generate))),
] + [
    (cell, fault, patch)
    for cell in ("soft_train_s64.glyph_u8", "soft_train_s64.glyph_pm2040")
    for fault, patch in (
        ("state unchanged", lambda mp: mp.setattr(chaq_sdfgen_tpu_torch, "make_train_step", _unchanged_step)),
        ("half the batch left out", lambda mp: mp.setattr(
            chaq_sdfgen_tpu_torch, "make_train_step", _half_batch_step(chaq_sdfgen_tpu_torch.make_train_step))),
        ("answer altered", lambda mp: mp.setattr(SoftSDFModel, "forward", _field_altered(SoftSDFModel.forward))),
    )
]


@pytest.mark.parametrize("cell,fault,patch", FAULTS, ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_planted_fault_makes_correct_false(monkeypatch, cell, fault, patch):
    patch(monkeypatch)
    result = _run(cell)
    assert result["correct"] is False, (fault, result["checks"])


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    res = subprocess.run([sys.executable, os.path.join(manifest.BENCH_DIR, "run.py"), "--workload",
                          "exact_s64.atlas_glyph", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=manifest.ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "cuda" in res.stderr.lower()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_short_run_on_the_card_is_correct(card, cell):
    res = subprocess.run([sys.executable, os.path.join(manifest.BENCH_DIR, "run.py"), "--workload", cell,
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=manifest.ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
