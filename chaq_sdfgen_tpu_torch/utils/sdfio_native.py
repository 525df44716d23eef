"""ctypes binding for the native sdfio codec (native/sdfio/sdfio.cpp); a
copy of chaq_sdfgen_tpu/utils/sdfio_native.py, which this package cannot
import without importing JAX.

Builds the shared library on first use if a compiler is present; every
entry returns None on unsupported input so callers can fall back to PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "build", "libsdfio.so"))
_SRC_DIR = os.path.abspath(os.path.join(_NATIVE_DIR, "sdfio"))


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO_PATH):
            try:
                subprocess.run(
                    ["make", "-s"], cwd=_SRC_DIR, check=True, capture_output=True, timeout=120
                )
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        for name in ("png", "bmp", "tga", "pnm", "jpg", "psd", "hdr", "pic", "gif"):
            dec = getattr(lib, f"sdfio_decode_{name}")
            dec.restype = ctypes.c_int
            dec.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
        for name in ("png", "bmp", "tga"):
            enc = getattr(lib, f"sdfio_encode_{name}")
            enc.restype = ctypes.c_int
            enc.argtypes = [
                ctypes.c_char_p,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t),
            ]
        lib.sdfio_encode_jpg.restype = ctypes.c_int
        lib.sdfio_encode_jpg.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.sdfio_free.restype = None
        lib.sdfio_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _sniff(data: bytes) -> Optional[str]:
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if data[:1] == b"P" and data[1:2] in (b"2", b"3", b"5", b"6"):
        return "pnm"
    if data[:3] == b"\xff\xd8\xff":
        return "jpg"
    if data[:4] == b"8BPS":
        return "psd"
    if data[:2] == b"#?":
        return "hdr"
    if data[:4] == b"\x53\x80\xf6\x34":
        return "pic"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    # TGA has no magic; accept via uncompressed type bytes
    if len(data) > 18 and data[1] == 0 and data[2] in (2, 3):
        return "tga"
    return None


def decode_gray_alpha(data: bytes) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    fmt = _sniff(data)
    if fmt is None:
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = getattr(lib, f"sdfio_decode_{fmt}")(data, len(data), ctypes.byref(out), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    try:
        n = w.value * h.value * 2
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.sdfio_free(out)
    return arr.reshape(h.value, w.value, 2)


def encode_gray(img: np.ndarray, filetype: str, quality: int = 100) -> Optional[bytes]:
    lib = _load()
    if lib is None or filetype not in ("png", "bmp", "tga", "jpg"):
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    if filetype == "jpg":
        rc = lib.sdfio_encode_jpg(
            img.tobytes(), w, h, int(quality), ctypes.byref(out), ctypes.byref(out_len)
        )
    else:
        rc = getattr(lib, f"sdfio_encode_{filetype}")(
            img.tobytes(), w, h, ctypes.byref(out), ctypes.byref(out_len)
        )
    if rc != 0:
        return None
    try:
        data = ctypes.string_at(out, out_len.value)
    finally:
        lib.sdfio_free(out)
    return data
