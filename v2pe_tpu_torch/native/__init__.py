"""Native (C++) host ops: build-on-first-import ctypes extension.

The reference leans on C++ third-party libs for its host data path
(decord, pillow-SIMD, opencv — SURVEY §2.11); our equivalent is a small
in-tree C++ extension compiled with the system toolchain. Falls back to the
pure-PIL path if no compiler is available (``available()`` reports state).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_LIB = None
_TRIED = False
_SRC = os.path.join(os.path.dirname(__file__), "image_ops.cpp")


def _cache_dir() -> str:
    """``V2PE_NATIVE_CACHE`` if set, else ``build/v2pe_tpu_torch/native`` at
    the root of the checkout (``build/`` is listed in ``.gitignore``)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.environ.get("V2PE_NATIVE_CACHE") or os.path.join(
        root, "build", "v2pe_tpu_torch", "native")


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    try:
        cache_dir = _cache_dir()
        os.makedirs(cache_dir, exist_ok=True)
        so_path = os.path.join(cache_dir, f"image_ops_{digest}.so")
        if os.path.exists(so_path):
            return so_path
        # a temporary name of this process's own, then an atomic rename:
        # processes that build at once never see each other's half file
        fd, tmp = tempfile.mkstemp(prefix=f"image_ops_{digest}.",
                                   suffix=".so.tmp", dir=cache_dir)
        os.close(fd)
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
               "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return so_path
    except Exception as e:
        logger.warning("native image_ops build failed (%s); using PIL path",
                       e)
        return None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.pil_resize_rgb_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                      u8p, ctypes.c_int, ctypes.c_int]
    lib.tile_resize_normalize.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, f32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def pil_resize_rgb(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """PIL-exact bicubic resize of an (H, W, 3) uint8 array."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((dh, dw, 3), np.uint8)
    lib.pil_resize_rgb_u8(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), dh, dw)
    return out


def tile_resize_normalize(img: np.ndarray, grid_w: int, grid_h: int,
                          image_size: int, use_thumbnail: bool,
                          mean, std) -> np.ndarray:
    """(H, W, 3) uint8 -> (n_tiles, 3, S, S) float32, PIL-pipeline-exact."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, np.uint8)
    blocks = grid_w * grid_h
    n = blocks + (1 if use_thumbnail and blocks != 1 else 0)
    out = np.empty((n, 3, image_size, image_size), np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    lib.tile_resize_normalize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        img.shape[0], img.shape[1], grid_w, grid_h, image_size,
        int(use_thumbnail),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
