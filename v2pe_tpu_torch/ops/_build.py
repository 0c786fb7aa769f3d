"""Build the CUDA kernels of ``v2pe_tpu_torch/csrc`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` to an object, one process per source,
all started together, then links the objects into one shared library with
a plain C interface, which is loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds). The library goes to ``build/v2pe_tpu_torch/<hash>/`` at the
root of the checkout (listed in ``.gitignore``); the hash covers the sources
and the compiler flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.

Not built with ``--use_fast_math``: the fused rotary computes ``sincosf`` of
angles up to the context length in radians, where the fast intrinsics lose
accuracy.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                          "v2pe_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0  # wall time of the last compile (0 if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "v2pe_tpu_torch are built on a machine with the "
                           "CUDA toolkit")
    return path


def library_path() -> str:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")) +
                     glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libv2pe_kernels.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        obj = os.path.join(os.path.dirname(out),
                           f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = f"{out}.{tag}"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and cached for the process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.v2pe_flash_fwd.argtypes = [
            p, p, p,            # q, k, v
            p, p, p, p,         # seg_q, seg_k, pos_q, pos_k
            p, p, p,            # rope_q, rope_k, inv_freq (may be NULL)
            p, p,               # out, lse
            i, i, i, i, i, i,   # B, Sq, Sk, Hq, Hkv, D
            i, i,               # is_bf16, causal
            ctypes.c_float,     # scale
            p,                  # cudaStream_t
        ]
        lib.v2pe_flash_fwd.restype = ctypes.c_int
        bwd_in = [
            p, p, p, p,         # q, k, v, do
            p, p,               # lse, di
            p, p, p, p,         # seg_q, seg_k, pos_q, pos_k
        ]
        bwd_dims = [
            i, i, i, i, i, i,   # B, Sq, Sk, Hq, Hkv, D
            i, i,               # is_bf16, causal
            ctypes.c_float,     # scale
            p,                  # cudaStream_t
        ]
        lib.v2pe_flash_bwd_dkv.argtypes = bwd_in + [p, p] + bwd_dims  # dk, dv
        lib.v2pe_flash_bwd_dq.argtypes = bwd_in + [p] + bwd_dims      # dq
        lib.v2pe_paged_store.argtypes = [
            p, p,               # k_new, v_new
            p, p, p, p,         # k_pages, v_pages, k_scales, v_scales
            p, p,               # page_table, lengths
            i, i, i, i, i, i,   # B, Hkv, NP, ps, D, MP
            i, i, i,            # layer, is_bf16, quantized
            p,                  # cudaStream_t
        ]
        lib.v2pe_paged_decode.argtypes = [
            p, p, p,            # q, k_new, v_new (fresh k/v may be NULL)
            p, p, p, p,         # k_pages, v_pages, k_scales, v_scales
            p, p, p,            # page_table, slot_base, lengths
            p, p,               # out, lse (may be NULL)
            i, i, i, i, i, i,   # B, T, Hq, Hkv, NP, ps
            i, i, i,            # D, MP, layer
            i, i, i, i,         # is_bf16, quantized, fresh_in_pages, fold
            ctypes.c_float,     # scale
            p,                  # cudaStream_t
        ]
        lib.v2pe_paged_prefill.argtypes = [
            p, p, p, p, p,      # q, k_pages, v_pages, k_scales, v_scales
            p, p, p,            # page_table, slot_base, lengths
            p, p,               # out, lse
            i, i, i, i, i, i,   # B, S, Hq, Hkv, NP, ps
            i, i, i,            # D, MP, layer
            i, i,               # is_bf16, quantized
            ctypes.c_float,     # scale
            p,                  # cudaStream_t
        ]
        for fn in (lib.v2pe_flash_bwd_dkv, lib.v2pe_flash_bwd_dq,
                   lib.v2pe_paged_store, lib.v2pe_paged_decode,
                   lib.v2pe_paged_prefill):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
