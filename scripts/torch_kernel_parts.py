"""Where soft_b1's and soft_mm_bwd's time goes, on one NVIDIA GPU: each
kernel timed as built, then built again from an edited copy of
chaq_sdfgen_tpu_torch/csrc with one part stripped out, so the difference is
that part's share. The edited kernels compute wrong values; they are timed
only, never used.

    python3 scripts/torch_kernel_parts.py

Parts (each an exact text replacement; a replacement that no longer matches
the sources stops the script):
  b1_no_taps      soft_b1 without its tap loops (staging, heights, reaches
                  and the VJP are left);
  b1_no_expf      soft_b1's taps without expf;
  mm_no_vjp       soft_mm_bwd without the tails' VJP (ds = the staged
                  cotangent and memo);
  mm_no_occ_vjp   soft_mm_bwd without the occupancy VJP (dgray = a sum);
  mm_divide       soft_mm_bwd dividing by T and tau where they are powers of
                  two too (no exact products).
Times: CUDA events around 10 back-to-back calls, the median of 5 windows
(chip_smoke.cuda_ms), at 4096x4096, spread 64, tau 2, T 1, on the inputs
chip_smoke.py uses; the card's name and power limit are printed first.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from chaq_sdfgen_tpu_torch.ops import _build, cuda_soft_mm, soft_fused, soft_mxu  # noqa: E402

PARTS = {
    "as built": [],
    "b1_no_taps": [("soft_fused.cu",
                    "const float dh0 = b1_taps(sv, sg, j, r0, h0, p.inv_t), "
                    "dh1 = b1_taps(sv + span, sg + span, j, r1, h1, p.inv_t);",
                    "const float dh0 = (float)r0, dh1 = (float)r1;")],
    "b1_no_expf": [("soft_fused.cu", "if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(expf(z), sg[q]));",
                    "if (z >= -kCut) acc = __fadd_rn(acc, __fmul_rn(z, sg[q]));")],
    "mm_no_vjp": [("soft_mm.cu", "prod(raw[e], raw[kBwdRows * kBwdIn + e], raw[2 * kBwdRows * kBwdIn + e], a, z);",
                   "a = raw[e], z = raw[kBwdRows * kBwdIn + e];")],
    "mm_no_occ_vjp": [("soft_mm.cu", "? epi(gv[m], e0[m], e1[m]) : 0.0f",
                       "? __fadd_rn(gv[m], __fadd_rn(e0[m], e1[m])) : 0.0f")],
    "mm_divide": [("soft_mm.cu", "shift, t, eps, pow2_inverse(t)};", "shift, t, eps, 0.0f};"),
                  ("soft_mm.cu", "test_above != 0, pow2_inverse(tau)};", "test_above != 0, 0.0f};")],
}


ORIG_CSRC = _build.CSRC_DIR


def build(edits, work):
    """Load the kernels' library built from a copy of csrc with ``edits``
    applied."""
    src = os.path.join(work, "csrc")
    shutil.copytree(ORIG_CSRC, src)
    for name, old, new in edits:
        path = os.path.join(src, name)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"{name}: the text to replace is not in the sources: {old[:60]}")
        open(path, "w").write(text.replace(old, new))
    _build.CSRC_DIR, _build.BUILD_DIR, _build._lib = src, os.path.join(work, "lib"), None
    _build.load()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_parts: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    band, tau, t = cs.SPREAD + 2, cs.TRAIN_TAU, cs.TRAIN_T
    rng = np.random.default_rng(cs.SEED + 5)
    glyph = cs.glyph_image(cs.SIZE, cs.SEED + 1)
    inputs = {
        "noise": torch.from_numpy((rng.random((cs.SIZE, cs.SIZE)) * 255).astype(np.float32)).to(dev),
        "pm2000": torch.from_numpy(cs.pm_noise((cs.SIZE, cs.SIZE), cs.SEED + 6)).to(dev),
        "glyph+-2040": torch.from_numpy(glyph[..., 1].astype(np.float32) / 255 * 4080 - 2040).to(dev),
    }
    with tempfile.TemporaryDirectory() as tmp:
        build([], os.path.join(tmp, "inputs"))
        b1_in = {}
        for name, g in inputs.items():
            s1 = soft_fused.f1_pass(g, band, tau, t)
            _, d2 = soft_fused.f2_pass(s1, band, t, cs.EPS)
            b1_in[name] = (g, s1, soft_fused.b2_pass(torch.ones_like(g), d2, s1, band, t, cs.EPS))
        g0 = inputs["noise"]
        k1, k2, c = soft_mxu.range_stats(band, tau, t, cs.U8)
        args = (c, k1, k2, tau, t, 1e-6, True)
        _, d2i, d2o = cuda_soft_mm.mm_fused_fwd(g0, *args)
        ct = torch.ones_like(g0)
        for part, edits in PARTS.items():
            build(edits, os.path.join(tmp, part.replace(" ", "_")))
            line = []
            if not part.startswith("mm"):
                for name, (g, s1, ds1) in b1_in.items():
                    ms = cs.cuda_ms(lambda: soft_fused.b1_pass(g, s1, ds1, band, tau, t))
                    line.append(f"soft_b1 {name} {ms:.4f}")
            if not part.startswith("b1"):
                ms = cs.cuda_ms(lambda: cuda_soft_mm.mm_fused_bwd(ct, d2i, d2o, g0, *args))
                line.append(f"soft_mm_bwd k {k1} {ms:.4f}")
            print(f"part {part}: " + ", ".join(line) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
