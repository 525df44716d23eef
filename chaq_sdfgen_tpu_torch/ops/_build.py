"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

The sources are compiled into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), named after a hash of the
sources and flags, under ``build/kernels/`` at the repository root. The
build happens at first use; later calls in the process reuse the loaded
library, and later processes reuse the file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

from chaq_sdfgen_tpu_torch.utils.profiling import recording, span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

# sm_90a: Hopper. No --use_fast_math: the kernels need IEEE sqrt and
# division and the accurate expf/logf (they also spell them as _rn
# intrinsics).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# what the last build in this process did: seconds, library path, and
# nvcc's stderr (ptxas register and spill counts)
BUILD_INFO: dict = {}


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libchaq_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists: one
    nvcc per source, all started together, then one link (the sources
    build in the time of the slowest, not of their sum)."""
    out = library_path()
    if os.path.exists(out):
        BUILD_INFO.update(seconds=0.0, path=out, log="(cached)")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (s for s in _sources() if s.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            jobs.append((obj, subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                               stderr=subprocess.PIPE, text=True)))
        logs = [(obj, proc.communicate()[1], proc.returncode) for obj, proc in jobs]
        failed = [f"nvcc failed ({rc}) for {obj}:\n{log}" for obj, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib, *(obj for obj, _ in jobs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        os.replace(lib, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=out, log="".join(l for _, l, _ in logs))
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, with its C signatures set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chaq_edt_rows.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
        lib.chaq_edt_rows.restype = i32
        # (din, dout, out, n, h, w, row_off, out_rows, band, s_min, s_max, apply_sqrt, elem_bytes, stream)
        lib.chaq_edt_band_bytes.argtypes = [
            vp, vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_float, ctypes.c_float, i32, i32, vp,
        ]
        lib.chaq_edt_band_bytes.restype = i32
        lib.chaq_refined_sqrt_f32.argtypes = [vp, vp, ctypes.c_longlong, vp]
        lib.chaq_refined_sqrt_f32.restype = i32
        f32 = ctypes.c_float
        # (h, band, elem_bytes, &staged): the path chaq_edt_band_bytes takes
        lib.chaq_edt_band_staged.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
        lib.chaq_edt_band_staged.restype = i32
        # (d, table, left, out, n, h, w, sat, stream)
        for entry in ("chaq_edt_dist_core", "chaq_edt_dist"):
            getattr(lib, entry).argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
            getattr(lib, entry).restype = i32
        # (codes, out, n, h, w, sent, elem_bytes, stream)
        lib.chaq_brute_rows.argtypes = [vp, vp, i32, i32, i32, i32, i32, vp]
        lib.chaq_brute_rows.restype = i32
        # (codes, strips, out, n, h, w, spread, s_min, s_max, invert, elem_bytes, stream)
        lib.chaq_brute_scan_bytes.argtypes = [vp, vp, vp, i32, i32, i32, i32, f32, f32, i32, i32, vp]
        lib.chaq_brute_scan_bytes.restype = i32
        # (codes, strips, out, n, h, hs, w, row_off, spread, s_min, s_max, invert, elem_bytes, stream)
        lib.chaq_brute_scan_bytes_halo.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32, f32, f32,
                                                   i32, i32, vp]
        lib.chaq_brute_scan_bytes_halo.restype = i32
        taps = ctypes.POINTER(f32)
        # (n, h_in, h_out, w, row_off, ylo, yhi, xlo, xhi, k1, k2, taps, tau, T, eps, shift,
        #  test_above, stream)
        soft_tail = [i32] * 11 + [taps, f32, f32, f32, f32, i32, vp]
        lib.chaq_soft_mm_fwd.argtypes = [vp, vp, vp, vp, *soft_tail]
        lib.chaq_soft_mm_fwd.restype = i32
        lib.chaq_soft_mm_bwd.argtypes = [vp, vp, vp, vp, vp, *soft_tail]
        lib.chaq_soft_mm_bwd.restype = i32
        # (n, h, w, band, scale, T, 1/T, eps, ylo, yhi, stream)
        fused_tail = [i32, i32, i32, i32, f32, f32, f32, f32, i32, i32, vp]
        for entry, n_ptrs in (("chaq_soft_f1", 2), ("chaq_soft_f2", 3), ("chaq_soft_b2", 4),
                              ("chaq_soft_b1", 4)):
            getattr(lib, entry).argtypes = [vp] * n_ptrs + fused_tail
            getattr(lib, entry).restype = i32
        # (n, nf, npos, nlanes, band, axis, implicit, pitch, col, T, 1/T, impl, stream)
        col_tail = [i32] * 9 + [f32, f32, i32, vp]
        for entry, n_ptrs in (("chaq_softmin_fwd", 3), ("chaq_softmin_bwd", 6)):
            getattr(lib, entry).argtypes = [vp] * n_ptrs + col_tail
            getattr(lib, entry).restype = i32
        # (n, h_in, h_out, w, k, row_off, taps, [T, eps, shift,] stream)
        conv_frame = [i32] * 6 + [taps]
        lib.chaq_cols_conv.argtypes = [vp, vp, *conv_frame, vp]
        lib.chaq_cols_conv.restype = i32
        for entry in ("chaq_p2_fused_fwd", "chaq_p2_fused_bwd"):
            getattr(lib, entry).argtypes = [vp] * 5 + conv_frame + [f32, f32, f32, vp]
            getattr(lib, entry).restype = i32
        ll = ctypes.c_longlong
        # ops/soft_front.py: (img2ch, v, mix, bias, tau, tau_s, pixels, stream);
        # (dv, img2ch, dimg2ch, partials, grads, mix, bias, tau, tau_s, pixels, stream);
        # (pred, target, partials, loss, n, divisor, stream); (pred, target, g, dpred, n, inv_n, stream)
        lib.chaq_soft_front_fwd.argtypes = [vp] * 5 + [f32, ll, vp]
        lib.chaq_soft_front_bwd.argtypes = [vp] * 8 + [f32, ll, vp]
        lib.chaq_soft_mse_fwd.argtypes = [vp] * 4 + [ll, ctypes.c_double, vp]
        lib.chaq_soft_mse_bwd.argtypes = [vp] * 4 + [ll, f32, vp]
        for entry in ("chaq_soft_front_fwd", "chaq_soft_front_bwd", "chaq_soft_mse_fwd", "chaq_soft_mse_bwd"):
            getattr(lib, entry).restype = i32
        # (jobs, n_jobs, n_img, row_bytes, stream): jobs packed as parallel/cuda_halo.py packs them
        for entry in ("chaq_halo_slab", "chaq_halo_ring_shift"):
            getattr(lib, entry).argtypes = [ctypes.c_char_p, i32, ll, ll, vp]
            getattr(lib, entry).restype = i32
        lib.chaq_enable_peer_access.argtypes = [i32, i32]
        lib.chaq_enable_peer_access.restype = i32
        _lib = lib
        return _lib


def launch(entry: str, device, *args) -> None:
    """Call a launcher of the kernels' library (built at first use) on
    the current stream of ``device``; raise if the launch failed. Under a
    profiler the call is the span ``launch.<entry>``."""
    if recording():
        with span("launch." + entry):
            return _launch(entry, device, args)
    _launch(entry, device, args)


def _launch(entry: str, device, args: tuple) -> None:
    lib = load()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with cudaError {rc}")


MAX_BATCH = 65535  # gridDim.z


def check_cuda(name: str, *tensors) -> None:
    """Raise unless the tensors share one device, are contiguous and are
    at least 2-D (..., H, W)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dim() < 2:
            raise ValueError(f"{name}: expected (..., H, W), got shape {tuple(t.shape)}")


def float32_on_cuda(name: str, *tensors) -> bool:
    """False for tensors on the CPU (the plain version's); for CUDA ones,
    check_cuda and float32, then True; any other device raises."""
    if tensors[0].device.type == "cpu":
        return False
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    check_cuda(name, *tensors)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32 tensors, got {t.dtype}")
    return True


def flat_shape(t) -> tuple:
    """(batch, H, W) of a (..., H, W) tensor, the batch within gridDim.z."""
    h, w = t.shape[-2:]
    n = t.numel() // max(h * w, 1)
    if n > MAX_BATCH:
        raise ValueError(f"batch of {n} images exceeds {MAX_BATCH}")
    return n, h, w
