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

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                          "v2pe_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
# the current stream of a device as an address, for a launch (a CUDA build
# of torch has the direct call, cheaper than the stream object)
raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
    lambda index: torch.cuda.current_stream(index).cuda_stream)
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
        bind_paged(lib)
        bind_qdot(lib)
        bind_mla(lib)
        ll = ctypes.c_longlong
        lib.v2pe_ring_fused_fwd.argtypes = [
            p, p, p,            # q, seg_q, pos_q (the launched ranks' rows)
            p,                  # (4, n) chunk pointers: k, v, seg_k, pos_k
            p, p,               # host arrays of the n k and v chunk addresses
            p, p,               # out, lse
            i, i, i, i, i, i,   # B, n, Sl, Hq, Hkv, D
            ll, ll,             # a chunk's batch strides: k/v, seg/pos
            i, i,               # is_bf16, causal
            ctypes.c_float,     # scale
            i, i,               # r0, nr: the ranks launched
            p,                  # cudaStream_t
        ]
        for fn in (lib.v2pe_ring_fused_fwd,
                   lib.v2pe_flash_bwd_dkv, lib.v2pe_flash_bwd_dq):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def bind_qdot(lib: ctypes.CDLL) -> None:
    """Argument types of the four quantized products' entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    qdot_tail = [
        i, i, i, i,         # M, D, Npad, n_out
        i, i,               # x_is_bf16, out_is_bf16
        i, i, i, i, i,      # the plan: body, mt, bn, splits, split_rows
        p,                  # cudaStream_t
    ]
    q4dot_tail = qdot_tail[:4] + [i] + qdot_tail[4:]  # + group size
    weight = [p, p, p, p,   # x, codes or packed nibbles, scale, out
              p, p]         # workspace, split counters (may be NULL)
    stack = [i, i]          # layer, layers
    lib.v2pe_qdot.argtypes = weight + qdot_tail
    lib.v2pe_qdot_stacked.argtypes = weight + stack + qdot_tail
    lib.v2pe_q4dot.argtypes = weight + q4dot_tail
    lib.v2pe_q4dot_stacked.argtypes = weight + stack + q4dot_tail
    for fn in (lib.v2pe_qdot, lib.v2pe_qdot_stacked, lib.v2pe_q4dot,
               lib.v2pe_q4dot_stacked):
        fn.restype = ctypes.c_int


def bind_mla(lib: ctypes.CDLL) -> None:
    """Argument types of the latent attention's entry point (#12)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.v2pe_mla_attention.argtypes = [
        p, p, p,            # q, fresh (NULL: the chunk form), pool
        p, p,               # page_table, lengths
        p, p, p,            # out, workspace, split counters (may be NULL)
        i, i, i, i, i, i,   # B, T, H, NP, ps, MP
        i, i, i,            # layer, splits, span
        ctypes.c_float,     # scale
        p,                  # cudaStream_t
    ]
    lib.v2pe_mla_attention.restype = ctypes.c_int


def bind_paged(lib: ctypes.CDLL) -> None:
    """Argument types of the three paged kernels' entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.v2pe_paged_store.argtypes = [
        p, p,               # k_new, v_new
        p, p, p, p,         # k_pages, v_pages, k_scales, v_scales
        p, p, p,            # page_table, lengths, fresh_pages (may be NULL)
        i, i, i, i, i, i,   # B, Hkv, NP, ps, D, MP
        i, i, i,            # layer, is_bf16, kv_bits (0, 8 or 4)
        p,                  # cudaStream_t
    ]
    lib.v2pe_paged_decode.argtypes = [
        p, p, p,            # q, k_new, v_new (fresh k/v may be NULL)
        p, p, p, p,         # k_pages, v_pages, k_scales, v_scales
        p, p, p,            # page_table, slot_base, lengths
        p, p,               # out, lse (may be NULL)
        i, i, i, i, i, i,   # B, T, Hq, Hkv, NP, ps
        i, i, i,            # D, MP, layer
        i, i, i, i,         # is_bf16, kv_bits, fresh_in_pages, fold
        ctypes.c_float,     # scale
        i, i, i,            # the plan: splits, entries a split, rows a block
        p, p,               # workspace, split counters (NULL at 1 split)
        i, p,               # store, store_n (NULL: all T tokens)
        p,                  # fresh_pages (NULL: from the page table)
        p,                  # cudaStream_t
    ]
    lib.v2pe_paged_prefill.argtypes = [
        p, p, p, p, p,      # q, k_pages, v_pages, k_scales, v_scales
        p, p, p,            # page_table, slot_base, lengths
        p, p,               # out, lse
        i, i, i, i, i, i,   # B, S, Hq, Hkv, NP, ps
        i, i, i,            # D, MP, layer
        i, i,               # is_bf16, kv_bits
        ctypes.c_float,     # scale
        i,                  # L: the pool's layers
        p,                  # cudaStream_t
    ]
    for fn in (lib.v2pe_paged_store, lib.v2pe_paged_decode,
               lib.v2pe_paged_prefill):
        fn.restype = ctypes.c_int
