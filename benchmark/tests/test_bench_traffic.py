"""The generator makes the same inputs from the same seed, other inputs from
other seeds, and keeps the mix's shapes and ranges."""

import pytest
import torch

from benchmark.harness import manifest, traffic

SMALL = {"cell": 32, "margin": 4}


def _mix(name):
    mix = manifest.resolve(manifest.load(), name).traffic
    if mix["channels"]["alpha"]["layer"] == "strokes":
        mix["channels"]["alpha"].update(SMALL)
    return mix


@pytest.mark.parametrize("cell", ["exact_s64.atlas_glyph", "exact_s64.dense_single",
                                  "soft_train_s64.glyph_u8", "soft_train_s64.glyph_pm2040"])
def test_inputs_are_deterministic_per_seed(cell):
    mix = _mix(cell)
    seed = 2**31 + 12345
    a = traffic.make_input(mix, (128, 96), 2, seed, 0, "cpu")
    b = traffic.make_input(mix, (128, 96), 2, seed, 0, "cpu")
    c = traffic.make_input(mix, (128, 96), 2, seed + 1, 0, "cpu")
    d = traffic.make_input(mix, (128, 96), 2, seed, 1, "cpu")
    assert a.shape == (2, 128, 96, 2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    if "target" in mix:
        t = traffic.make_target(mix, (128, 96), 2, seed, 0, "cpu")
        assert t.shape == (2, 128, 96) and torch.equal(t, traffic.make_target(mix, (128, 96), 2, seed, 0, "cpu"))
        assert float(t.min()) >= mix["target"]["low"] and float(t.max()) <= mix["target"]["high"]


def test_glyph_pages_are_sparse_strokes_and_noise():
    mix = _mix("exact_s64.atlas_glyph")
    x = traffic.make_input(mix, (256, 256), 4, 7, 0, "cpu")
    assert x.dtype == torch.uint8
    alpha = x[..., 1]
    assert set(alpha.unique().tolist()) <= {0, 255}
    on = float((alpha > 127).float().mean())
    assert 0.01 < on < 0.5  # strokes cover a small share of the page
    assert len(x[..., 0].unique()) > 200  # gray is noise


def test_pm2040_is_the_u8_page_mapped():
    u8 = traffic.make_input(_mix("soft_train_s64.glyph_u8"), (64, 64), 2, 5, 0, "cpu")
    pm = traffic.make_input(_mix("soft_train_s64.glyph_pm2040"), (64, 64), 2, 5, 0, "cpu")
    assert u8.dtype == pm.dtype == torch.float32
    assert torch.equal(pm, (u8 - 127.5) * 16.0)
    assert float(pm.abs().max()) == 2040.0


def test_negative_and_huge_seeds_are_taken():
    assert traffic.sub_seed(-1, 0) == traffic.sub_seed(2**64 - 1, 0)
    assert 0 <= traffic.sub_seed(2**40, 3, 9) < 2**63
