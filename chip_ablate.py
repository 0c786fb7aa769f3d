"""Time variants of the flash backward's CUDA source against each other on
one CUDA card, in one process, so that their times compare.

    python3 chip_ablate.py [--variants kernel,expf,...] [--iters 20]

Each variant is ``v2pe_tpu_torch/csrc/flash_bwd.cu`` and ``flash_tile.cuh``
with one named edit (VARIANTS), written under ``build/ablate/<name>/`` and
built alone into a shared library by ``nvcc``, all builds started together.
Both bf16 kernels of every variant are timed (``chip_smoke.time_ms``, the
best of three) at the ViT's form (8 tiles of 1025 tokens, 16 x 64,
bidirectional), the packed 8192-token form (three segments and a padded
tail, 16/8 x 128, causal) and one causal 8192-token segment, beside the
library's backward of the same attention where it expresses the form.
Each line also gives the variant's largest difference from the port's own
kernels relative to the gradient's range: the ablations (``no_*``) compute
something else and are there only for their time. Prints the compiler's
registers, spills and ``wgmma`` notes of each variant first.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "v2pe_tpu_torch", "csrc")
OUT = os.path.join(HERE, "build", "ablate")

# name: the edits (file, text, replacement); "kernel" is the source as it is
VARIANTS = {
    "kernel": [],
    "expf": [("flash_bwd.cu", "exp_sfu(s[i] * scale - lse)",
              "expf(s[i] * scale - lse)")],
    "stages3": [("flash_tile.cuh", "constexpr int STAGES = 2;",
                 "constexpr int STAGES = 3;")],
    "dkv_2_blocks": [("flash_bwd.cu",
                      "__launch_bounds__(tc::THREADS, D == 64 ? 2 : 1)",
                      "__launch_bounds__(tc::THREADS, 2)")],
    "no_exp": [("flash_bwd.cu", "exp_sfu(s[i] * scale - lse)",
                "(s[i] * scale - lse)")],
    "no_load": [("flash_tile.cuh", "mbar_arrive_tx(bar, loads * BOX_BYTES);",
                 "mbar_arrive(bar);"),
                ("flash_tile.cuh", "for (int x = 0; x < BOXES; ++x) {",
                 "for (int x = 0; x < BOXES && loads < 0; ++x) {")],
    "no_accumulate": [("flash_bwd.cu", "    accumulate<D>(",
                       "    if (p.B < 0) accumulate<D>(")],
}


def write_variant(name: str) -> str:
    """The variant's sources under OUT/name; returns its directory."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in ("flash_bwd.cu", "flash_tile.cuh"):
        with open(os.path.join(CSRC, f)) as fh:
            text = fh.read()
        for where, old, new in VARIANTS[name]:
            if where == f:
                if old not in text:
                    raise ValueError(f"{name}: {old!r} not in {f}")
                text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def build(names) -> dict:
    """Build every variant at once; returns name -> loaded library."""
    from v2pe_tpu_torch.ops import _build

    procs = []
    for name in names:
        d = write_variant(name)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", os.path.join(d, "lib.so"),
               os.path.join(d, "flash_bwd.cu")]
        procs.append((name, d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    tail = [i] * 8 + [ctypes.c_float, p]
    for name, d, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        regs = [ln.split("Used")[1].split(",")[0].strip()
                for ln in lines if "Used" in ln]
        notes = [ln.strip() for ln in lines
                 if ("spill" in ln and " 0 bytes spill stores" not in ln)
                 or ("wgmma" in ln and "Compiling" not in ln)]
        print(f"variant {name}: registers {regs}; {notes or 'no spills'}",
              flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        lib.v2pe_flash_bwd_dkv.argtypes = [p] * 12 + tail
        lib.v2pe_flash_bwd_dq.argtypes = [p] * 11 + tail
        libs[name] = lib
    return libs


def forms(device="cuda"):
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g).to(device, torch.bfloat16)
    ar = lambda B, S: torch.arange(S, dtype=torch.int32, device=device
                                   ).expand(B, S).contiguous()
    S = cs.PACKED_LEN
    seg3 = torch.ones(1, S, dtype=torch.int32, device=device)
    seg3[:, S // 3:], seg3[:, 2 * S // 3:], seg3[:, S - 200:] = 2, 3, 0
    one = torch.ones(1, S, dtype=torch.int32, device=device)
    vit = torch.ones(8, 1025, dtype=torch.int32, device=device)
    llm = lambda seg: (rn(1, S, 16, 128), rn(1, S, 8, 128), rn(1, S, 8, 128),
                       seg, seg, ar(1, S), ar(1, S))
    return [("vit_tiles_8x1025_bf16", (rn(8, 1025, 16, 64),
                                       rn(8, 1025, 16, 64),
                                       rn(8, 1025, 16, 64), vit, vit,
                                       ar(8, 1025), ar(8, 1025)), False),
            (f"llm_packed_{S}_3seg_pad_bf16", llm(seg3), True),
            (f"causal_{S}_one_segment_bf16", llm(one), True)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device", file=sys.stderr)
        return 1
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    libs = build(args.variants.split(","))
    ptr = flash_fwd._ptr
    stream = torch.cuda.current_stream().cuda_stream
    for name, fargs, causal in forms():
        q, k, v = fargs[:3]
        scale = q.shape[3] ** -0.5
        out, lse = flash_fwd.flash_attention_fwd(*fargs, causal=causal,
                                                 scale=scale)
        do = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            1)).to(out)
        ref = flash_bwd.flash_attention_bwd(*fargs, out, lse, do,
                                            causal=causal, scale=scale)
        di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        B, Sq, Hq, D = q.shape
        dims = (B, Sq, k.shape[1], Hq, k.shape[2], D, 1, int(causal), scale,
                stream)
        ins = [ptr(t) for t in (*fargs[:3], do, lse, di, *fargs[3:])]
        for vname, lib in libs.items():
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            dkv = lambda: lib.v2pe_flash_bwd_dkv(*ins, ptr(dk), ptr(dv),
                                                 *dims)
            dqf = lambda: lib.v2pe_flash_bwd_dq(*ins, ptr(dq), *dims)
            if dkv() != 0 or dqf() != 0:
                raise RuntimeError(f"{vname}: launch failed")
            torch.cuda.synchronize()
            diff = max(cs._grad_rel(a, b) for a, b in zip((dq, dk, dv), ref))
            t_dkv = min(cs.time_ms(dkv, args.iters) for _ in range(3))
            t_dq = min(cs.time_ms(dqf, args.iters) for _ in range(3))
            print(f"ablate {name} {vname}: dkv {t_dkv:.4f} ms + dq "
                  f"{t_dq:.4f} ms = {t_dkv + t_dq:.4f} ms; max|d-kernel|/"
                  f"max|kernel| {diff:.2e}", flush=True)
        if not name.startswith("llm_packed"):  # no segments in the library
            lib_ms = cs.sdpa_backward_ms(q, k, v, do, causal, scale)
            print(f"ablate {name} library (the backward of "
                  f"scaled_dot_product_attention): "
                  f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}",
                  flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
