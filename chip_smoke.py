"""Smoke run of the PyTorch port on one NVIDIA GPU (the Hopper H100 target).

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. the card's name and power limit; a CUDA device is required;
  2. build the kernels from chaq_sdfgen_tpu_torch/csrc with nvcc, and the
     native PNG codec (native/sdfio) with make;
  3. each kernel against its plain PyTorch version on the card, byte for
     byte (tolerance 0), at 4096x4096 on dense noise and on a sparse
     glyph-like image for spreads 1/64/300/1024, on odd shapes, uniform
     masks and a batch of 3;
  4. the pass-2 sqrt tail against numerics.refined_sqrt on all 2^24
     integer radicands;
  5. the main path: the CLI (python -m chaq_sdfgen_tpu_torch -i in.png
     -o out.png -s 64) on a 4096x4096 gray+alpha PNG made from a seed,
     checked against the plain pipeline on the card; SDFGenerator at 256x256
     against the NumPy oracle of the reference binary; and the launch
     counters of both kernels over one SDFGenerator run of the main path;
  6. times with CUDA events (one warm-up, median of 10): each pass and the
     whole pipeline, kernels against plain versions, at 4096x4096 spread 64
     on both inputs;
  7. where the main path's device time goes: torch.profiler over 10 runs
     on the glyph input, device time per kernel and the device's busy share
     of the window (profiler on).
The last three lines are the nvidia-smi line, the kernels' JSON summary
and {"ok": true, ...}.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from chaq_sdfgen_tpu_torch.config import SdfConfig
from chaq_sdfgen_tpu_torch.models.sdf_model import SDFGenerator
from chaq_sdfgen_tpu_torch.ops import _build, cuda_edt, threshold
from chaq_sdfgen_tpu_torch.ops.numerics import refined_sqrt
from chaq_sdfgen_tpu_torch.utils import imageio, sdfio_native

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 4096
SPREAD = 64
SEED = 20261016
TIMING_ITERS = 10

KERNELS = {
    "edt_rows": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/edt.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_edt.py:169",
    },
    "edt_band_bytes": {
        "route": "cuda",
        "source": "chaq_sdfgen_tpu_torch/csrc/edt.cu",
        "replaces": "chaq_sdfgen_tpu/ops/pallas_edt.py:336",
    },
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape and a.dtype == b.dtype, f"shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max())


def glyph_image(size: int, seed: int) -> np.ndarray:
    """(size, size, 2) gray+alpha: a few thousand stroke segments, 2-10 px
    thick, in alpha (a sparse glyph-atlas-like mask); noise in gray."""
    rng = np.random.default_rng(seed)
    alpha = np.zeros((size, size), np.uint8)
    cell = 128
    for cy in range(0, size, cell):
        for cx in range(0, size, cell):
            if rng.random() < 0.35:
                continue  # empty atlas cells: large distances live there
            for _ in range(rng.integers(1, 4)):
                p0 = rng.uniform(16, cell - 16, 2)
                p1 = rng.uniform(16, cell - 16, 2)
                r = rng.uniform(1, 5)
                yy, xx = np.mgrid[:cell, :cell].astype(np.float32)
                d = p1 - p0
                t = np.clip(((yy - p0[0]) * d[0] + (xx - p0[1]) * d[1]) / max(d @ d, 1e-6), 0, 1)
                dist2 = (yy - p0[0] - t * d[0]) ** 2 + (xx - p0[1] - t * d[1]) ** 2
                alpha[cy : cy + cell, cx : cx + cell][dist2 <= r * r] = 255
    gray = rng.integers(0, 256, size=(size, size), dtype=np.uint8)
    return np.stack([gray, alpha], -1)


def noise_image(size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(size, size, 2), dtype=np.uint8)


def png_gray_alpha(img2ch: np.ndarray) -> bytes:
    """Minimal PNG encoder for 8-bit gray+alpha (color type 4)."""
    h, w, _ = img2ch.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img2ch.reshape(h, 2 * w)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 4, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + chunk(b"IEND", b"")
    )


def cuda_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs, CUDA events, after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    log(f"card: {smi}")
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.perf_counter()
    _build.load()
    log(f"build: kernels {_build.BUILD_INFO['seconds']:.2f} s -> {os.path.relpath(_build.BUILD_INFO['path'], ROOT)}")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  ptxas: {line.split(':', 1)[-1].strip()}")
    t1 = time.perf_counter()
    require(sdfio_native.available(), "native/sdfio codec did not build")
    log(f"build: native/sdfio {time.perf_counter() - t1:.2f} s; total {time.perf_counter() - t0:.2f} s")

    # phase 3: each kernel against its plain version, byte for byte
    err = {"edt_rows": 0, "edt_band_bytes": 0}
    noise = noise_image(SIZE, SEED)
    glyph = glyph_image(SIZE, SEED + 1)
    inputs = {
        "noise": threshold.hard_threshold(torch.from_numpy(noise).to(dev)),
        "glyph": threshold.hard_threshold(torch.from_numpy(glyph).to(dev)),
    }
    log(f"inputs: {SIZE}x{SIZE}, TRUE share noise {float(inputs['noise'].float().mean()):.4f} "
        f"glyph {float(inputs['glyph'].float().mean()):.4f}")

    def check(name: str, b: torch.Tensor, spread: int, asymmetric: bool = False) -> None:
        band = spread + 2
        din, dout = cuda_edt.row_distances_u8(b, band)
        pin, pout = cuda_edt.row_distances_u8_plain(b, band)
        e1 = max(max_abs_err(din, pin), max_abs_err(dout, pout))
        apply_sqrt = b.shape[-2] > 1
        got = cuda_edt.fused_pass2_bytes(din, dout, spread, asymmetric, band, apply_sqrt)
        want = cuda_edt.fused_pass2_bytes_plain(pin, pout, spread, asymmetric, band, apply_sqrt)
        e2 = max_abs_err(got, want)
        torch.cuda.synchronize()
        err["edt_rows"] = max(err["edt_rows"], e1)
        err["edt_band_bytes"] = max(err["edt_band_bytes"], e2)
        log(f"check {name} {tuple(b.shape)} spread {spread}{' asym' if asymmetric else ''}: "
            f"edt_rows err {e1}, edt_band_bytes err {e2}")
        require(e1 == 0 and e2 == 0, f"kernel disagrees with its plain version on {name}")

    for name, b in inputs.items():
        for spread in (1, 64, 300, 1024):
            check(name, b, spread)
    check("glyph", inputs["glyph"], 64, asymmetric=True)
    rng = np.random.default_rng(SEED + 2)
    for shape in ((1, 17), (17, 1), (139, 131), (3, 256, 256)):
        b = torch.from_numpy(rng.random(shape) < 0.3).to(dev)
        for spread in (1, 64):
            check("random", b, spread)
    for fill in (False, True):
        for spread in (64, 1024):
            check(f"uniform-{fill}", torch.full((512, 384), fill, device=dev), spread)
    codes = torch.from_numpy(rng.integers(0, 3, size=(139, 131), dtype=np.uint8)).to(dev)
    e = max(max_abs_err(a, p) for a, p in zip(cuda_edt.row_distances_u8(codes, 66),
                                              cuda_edt.row_distances_u8_plain(codes, 66)))
    log(f"check tri-state codes (139, 131): edt_rows err {e}")
    require(e == 0, "edt_rows disagrees on tri-state codes")

    # phase 4: the sqrt tail on every integer radicand below 2^24
    n = torch.arange(1 << 24, dtype=torch.float32, device=dev)
    bad = int((cuda_edt.refined_sqrt_cuda(n).view(torch.int32) != refined_sqrt(n).view(torch.int32)).sum())
    log(f"check refined_sqrt tail over 2^24 integers: {bad} mismatches")
    require(bad == 0, "the kernel's sqrt tail differs from numerics.refined_sqrt")
    del n

    # phase 5: the main path
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        in_png, out_png = os.path.join(tmp, "in.png"), os.path.join(tmp, "out.png")
        with open(in_png, "wb") as f:
            f.write(png_gray_alpha(glyph))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", "import chaq_sdfgen_tpu_torch"], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        require(res.returncode == 0, f"import failed: {res.stderr[-2000:]}")
        log(f"main path: python start + import chaq_sdfgen_tpu_torch {time.perf_counter() - t0:.2f} s wall")
        cmd = [sys.executable, "-m", "chaq_sdfgen_tpu_torch", "-i", in_png, "-o", out_png,
               "-s", str(SPREAD), "--log-level", "info"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        require(res.returncode == 0, f"CLI failed ({res.returncode}): {res.stderr[-2000:]}")
        for line in res.stderr.splitlines():
            log(f"  cli: {line}")
        cli_out = imageio.load_gray_alpha(out_png)[..., 0]
    want = cuda_edt.fused_sdf_bytes_plain(inputs["glyph"], SPREAD).cpu().numpy()
    require(cli_out.shape == (SIZE, SIZE), f"CLI output shape {cli_out.shape}")
    cli_err = int(np.abs(cli_out.astype(np.int32) - want.astype(np.int32)).max())
    log(f"main path: CLI {SIZE}x{SIZE} -s {SPREAD} in {cli_s:.2f} s wall (process, decode, "
        f"build cache, encode); max abs err vs plain pipeline {cli_err}")
    require(cli_err == 0, "CLI output differs from the plain pipeline")

    from sdfref import oracle

    small = glyph[:256, :256]
    gen_small = SDFGenerator(SdfConfig(spread=SPREAD), device=dev).generate(small).cpu().numpy()
    ora_err = int(np.abs(gen_small.astype(np.int32) - oracle.sdf_pipeline_openmp(small, spread=SPREAD)).max())
    log(f"main path: SDFGenerator 256x256 vs the reference oracle: max abs err {ora_err}")
    require(ora_err == 0, "SDFGenerator differs from the oracle of the reference binary")

    gen = SDFGenerator(SdfConfig(spread=SPREAD), device=dev)
    img_dev = torch.from_numpy(glyph).to(dev)
    torch.cuda.synchronize()
    for k in cuda_edt.LAUNCHES:
        cuda_edt.LAUNCHES[k] = 0
    out = gen.generate(img_dev)
    torch.cuda.synchronize()
    launches = dict(cuda_edt.LAUNCHES)
    log(f"main path: SDFGenerator {SIZE}x{SIZE} launches {launches}")
    for k, v in launches.items():
        require(v > 0, f"kernel {k} was not launched on the main path")
    require(out.shape == (SIZE, SIZE) and out.dtype == torch.uint8, "main path output shape/dtype")
    require(bool((out.cpu().numpy() == cli_out).all()), "SDFGenerator and CLI outputs differ")

    # phase 6: times at 4096x4096 spread 64 (CUDA events, median of 10)
    band = SPREAD + 2
    times = {}
    for name, b in inputs.items():
        img = torch.from_numpy(noise if name == "noise" else glyph).to(dev)
        din, dout = cuda_edt.row_distances_u8(b, band)
        t = {
            "edt_rows": cuda_ms(lambda: cuda_edt.row_distances_u8(b, band)),
            "edt_rows_plain": cuda_ms(lambda: cuda_edt.row_distances_u8_plain(b, band)),
            "edt_band_bytes": cuda_ms(lambda: cuda_edt.fused_pass2_bytes(din, dout, SPREAD, False, band)),
            "edt_band_bytes_plain": cuda_ms(
                lambda: cuda_edt.fused_pass2_bytes_plain(din, dout, SPREAD, False, band)),
            "pipeline": cuda_ms(lambda: gen.generate(img)),
            "pipeline_plain": cuda_ms(
                lambda: cuda_edt.fused_sdf_bytes_plain(threshold.hard_threshold(img), SPREAD)),
        }
        times[name] = t
        for k, ms in t.items():
            log(f"time {name} {k}: {ms:.4f} ms  {SIZE * SIZE / ms / 1e6:.3f} Gpix/s")

    # phase 7: device time by kernel over the main path, and the busy share
    from torch.profiler import ProfilerActivity, profile

    img = torch.from_numpy(glyph).to(dev)
    gen.generate(img)
    torch.cuda.synchronize()
    runs = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            gen.generate(img)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0 and e.cpu_time_total == 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        log(f"profile: {e.self_device_time_total / runs / 1e3:.4f} ms/run "
            f"{100 * e.self_device_time_total / busy_us:.1f}%  {e.key[:90]}")
    log(f"profile: device busy {busy_us / runs / 1e3:.4f} ms/run of a {window_us / runs / 1e3:.4f} ms/run "
        f"window ({100 * busy_us / window_us:.1f}% busy, profiler on)")

    print(smi, flush=True)
    main_t = times["glyph"]
    summary = {
        "kernels": [
            dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=err[k],
                 ms=main_t[k], plain_ms=main_t[f"{k}_plain"])
            for k in KERNELS
        ]
    }
    print(json.dumps(summary))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
