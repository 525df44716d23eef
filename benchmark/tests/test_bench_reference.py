"""The plain references: the EXACT bytes against a NumPy brute-force EDT at
64 x 64, and the soft step's gradient against finite differences."""

import math

import numpy as np
import pytest
import torch

from benchmark.harness import manifest

REF = {name: manifest.load_module(manifest.reference_path(name), "test_ref_" + name)
       for name in ("exact_sdf", "soft_train")}
SDF = {"spread": 64, "asymmetric": False, "channel": "alpha", "invert": False}


def brute_bytes(img2ch: np.ndarray, spread: int, asymmetric: bool) -> np.ndarray:
    """The OpenMP binary's bytes by brute force: each pixel's distance to
    every pixel of the other polarity, the -1 bias, the float32 remap."""
    b = img2ch[..., 1] > 127
    h, w = b.shape
    yy, xx = np.mgrid[:h, :w]
    pts = np.stack([yy.ravel(), xx.ravel()], 1)

    def nearest(mask):
        seeds = pts[mask.ravel()]
        if len(seeds) == 0:
            return np.full(h * w, np.inf, np.float32)
        d2 = ((pts[:, None, :] - seeds[None, :, :]) ** 2).sum(-1).min(1)
        return np.sqrt(d2.astype(np.float32), dtype=np.float32)

    inside, outside = nearest(b), nearest(~b)  # to TRUE, to FALSE
    biased = np.where(inside > 0, inside + np.float32(-1.0), inside).astype(np.float32)
    v = (outside - biased).astype(np.float32)
    s_min = np.float32(0.0 if asymmetric else -spread)
    s_max = np.float32(spread)
    v = np.maximum(np.minimum(v, s_max), s_min)
    return (((v - s_min) * np.float32(255.0)) / (s_max - s_min) + np.float32(0.0)).astype(np.uint8).reshape(h, w)


def _image(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (64, 64, 2), dtype=np.uint8)
    img = np.zeros((64, 64, 2), np.uint8)
    yy, xx = np.mgrid[:64, :64]
    for _ in range(3):  # a few discs and a bar
        cy, cx, r = rng.integers(8, 56), rng.integers(8, 56), rng.integers(2, 9)
        img[..., 1][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 255
    img[rng.integers(0, 64), :, 1] = 255
    return img


@pytest.mark.parametrize("kind,seed,spread,asym", [("glyph", 1, 64, False), ("glyph", 2, 8, False),
                                                  ("glyph", 3, 5, True), ("noise", 4, 64, False),
                                                  ("empty", 5, 64, False)])
def test_exact_reference_equals_brute_force(kind, seed, spread, asym):
    img = np.zeros((64, 64, 2), np.uint8) if kind == "empty" else _image(kind, seed)
    cfg = dict(SDF, spread=spread, asymmetric=asym)
    got = REF["exact_sdf"].sdf_bytes(torch.from_numpy(img), cfg).numpy()
    np.testing.assert_array_equal(got, brute_bytes(img, spread, asym))


def test_exact_reference_takes_a_batch():
    imgs = np.stack([_image("glyph", 6), _image("noise", 7)])
    got = REF["exact_sdf"].sdf_bytes(torch.from_numpy(imgs), SDF).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], brute_bytes(imgs[i], 64, False))


def test_bfloat16_bytes_differ_on_glyphs():
    img = torch.from_numpy(_image("glyph", 8))
    a = REF["exact_sdf"].sdf_bytes(img, SDF)
    b = REF["exact_sdf"].sdf_bytes(img, SDF, precision="bfloat16")
    assert int((a != b).sum()) > 0


MODEL = {"spread": 3, "tau": 2.0, "temperature": 1.0, "eps": 1e-6,
         "init": {"threshold_bias": 0.0, "log_tau": "log(tau)", "channel_mix": [0.0, 4.0]}}


def _batch(scale: float):
    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, 10, 12, 2), generator=g, dtype=torch.float64) * 255.0
    x[..., 1] = torch.where(x[..., 1] > 150, 255.0, 0.0)
    x = (x - 127.5) * scale + 127.5
    t = torch.rand((2, 10, 12), generator=g, dtype=torch.float64) * 8 - 4
    return x, t


@pytest.mark.parametrize("scale", [1.0, 16.0])
def test_soft_gradient_matches_finite_differences(scale):
    ref = REF["soft_train"]
    x, t = _batch(scale)
    params = ref.init_params(MODEL, torch.float64, "cpu")
    params["threshold_bias"] = torch.tensor(0.3, dtype=torch.float64)
    _, grads = ref.loss_and_grads(params, x, t, MODEL, torch.float64)
    h = 1e-5
    for key, idx in (("threshold_bias", ()), ("log_tau", ()), ("channel_mix", (0,)), ("channel_mix", (1,))):
        vals = []
        for sign in (1, -1):
            p = {k: v.clone() for k, v in params.items()}
            p[key][idx] += sign * h
            vals.append(float(ref.loss_and_grads(p, x, t, MODEL, torch.float64)[0]))
        fd = (vals[0] - vals[1]) / (2 * h)
        assert float(grads[key][idx]) == pytest.approx(fd, rel=1e-5, abs=1e-9), (key, idx)


def test_softmin_is_the_banded_logsumexp():
    ref = REF["soft_train"]
    g = torch.Generator().manual_seed(4)
    h = torch.rand((3, 9), generator=g, dtype=torch.float64) * 20
    out = ref.softmin(h, 2, 1.5, -1)
    for p in range(9):
        taps = [-(d * d + float(h[1, p + d])) / 1.5 for d in range(-2, 3) if 0 <= p + d < 9]
        want = -1.5 * math.log(sum(math.exp(z) for z in taps))
        assert float(out[1, p]) == pytest.approx(want, rel=1e-12)


def test_adam_steps_follow_torch_adam():
    ref = REF["soft_train"]
    x, t = _batch(1.0)
    config = {"model": MODEL, "optimizer": {"lr": 0.01, "b1": 0.9, "b2": 0.999, "eps": 1e-8}}
    got = ref.train([x, x.flip(1), x.flip(2)], [t, t, t], config)
    params = ref.init_params(MODEL, torch.float64, "cpu")
    leaves = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    opt = torch.optim.Adam(leaves.values(), lr=0.01, betas=(0.9, 0.999), eps=1e-8)
    for xb in (x, x.flip(1), x.flip(2)):
        _, grads = ref.loss_and_grads({k: v.detach() for k, v in leaves.items()}, xb, t, MODEL, torch.float64)
        for k, v in leaves.items():
            v.grad = grads[k].clone()
        opt.step()
    for k in leaves:
        assert got["change"][k] == pytest.approx(float((leaves[k].detach() - params[k]).norm()), rel=1e-9)
