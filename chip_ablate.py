"""Time variants of a kernel's CUDA source against each other on one CUDA
card, in one process, so that their times compare.

    python3 chip_ablate.py [--family flash_bwd|qmm|paged|e2e]
                           [--variants a,b,...|none] [--iters 20]
                           [--parent DIR] [--sweep]

Family ``flash_bwd`` (the default): each variant is
``v2pe_tpu_torch/csrc/flash_bwd.cu`` and ``flash_tile.cuh`` (with
``hopper.cuh``) with one named edit (VARIANTS), written under
``build/ablate/<name>/`` and built alone into a shared library by ``nvcc``,
all builds started together.
Both bf16 kernels of every variant are timed (``chip_smoke.time_ms``, the
best of three) at the ViT's form (8 tiles of 1025 tokens, 16 x 64,
bidirectional), the packed 8192-token form (three segments and a padded
tail, 16/8 x 128, causal) and one causal 8192-token segment, beside the
library's backward of the same attention where it expresses the form.
Each line also gives the variant's largest difference from the port's own
kernels relative to the gradient's range: the ablations (``no_*``) compute
something else and are there only for their time. Prints the compiler's
registers, spills and ``wgmma`` notes of each variant first.

Family ``paged``: variants of ``paged_attention.cu`` (PAGED_VARIANTS: an
edit of the source, a change of ``decode_plan``'s split count, or both),
built the same way under ``build/ablate/paged_<name>/``, and with
``--parent DIR`` the paged source of another checkout (unpacked into DIR,
e.g. by ``git archive``) as the variant ``parent``, bound through its own
entry points. Each variant is held against the plain version at the paged
kernels' main forms (twice into NaN-filled outputs, equal bits) and timed
on the device beside scaled_dot_product_attention on the K/V gathered
beforehand; with ``parent``, decode forms also give the median host time
of a call of this checkout's decode wrapper and of the parent's own
(``parent_wrappers``), called in turns.
The decode split counters are cleared after each variant. ``--sweep``
runs chip_smoke.py's random sweep of #5-#6 through each variant instead.
The variant ``store_apart`` (no source edit; this checkout's library) is
the decode step's store done apart: #5 without its store plus the
standalone store kernel #4 (one launch a fresh token), against #5 with the
store riding in its launch, at the decode forms (the served rows, one row
over 32k, the session's 34k row, the engine's 8 rows, its T = 5 verify
forward; bf16, int8 and int4 pools): both arms bit for bit equal (outputs
and pool), their device times (#5 alone and #4 alone too), and the median
host time of a layer's call, the wrapper pair against the single call,
called in turns.

Family ``e2e`` (with ``--parent DIR``): ``chip_smoke.py --e2e`` run on
the parent checkout's package and on this one's, each in a process of its
own, in turns (parent, this, this, parent): one sample each of the decode
paths' end-to-end numbers (``chip_smoke.e2e_samples``), printed side by
side.

Family ``qmm``: variants of ``quantized_matmul.cu`` (QMM_VARIANTS: an edit
of the source, a change of ``launch_plan``'s split of the strip body's
depth, or both), built the same way under ``build/ablate/qmm_<name>/``.
Each is held against the plain version (its outputs allocated full of
NaN, so that an element it leaves unwritten fails) and timed at the
decode forms (M = 1 and 3), the prefill forms (the 8-tile prompt's 2167
rows and its last 119-row chunk) of the layer products and the head, int8
and int4, beside ``F.linear`` on a bf16 weight of the same shape.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
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


# quantized_matmul.cu: name -> (edits, plan rule); the rule maps
# launch_plan's plan (and K, Npad, M, the split granule) to the variant's,
# or to None to skip the form (no rule: launch_plan's own)
QMM_VARIANTS = {
    "kernel": ([], None),
    "strip_int8_4k": ([("quantized_matmul.cu",
                        "TILE = INT4 ? 4096 : 8192;", "TILE = 4096;"),
                       ("quantized_matmul.cu",
                        "STAGES = INT4 ? 6 : 4;", "STAGES = 6;")], None),
    "strip_stages8": ([("quantized_matmul.cu",
                        "STAGES = INT4 ? 6 : 4;", "STAGES = INT4 ? 8 : 6;")],
                      None),
    "strip_2_blocks": ([("quantized_matmul.cu",
                         "constexpr int STRIP_MIN_BLOCKS = 4;",
                         "constexpr int STRIP_MIN_BLOCKS = 2;")], None),
    "no_split_handshake": ([("quantized_matmul.cu",
                             "    last = before == p.splits - 1;",
                             "    last = 0 * before;")], None),
    "strip_empty": ([("quantized_matmul.cu",
                      "  constexpr int PER = Strip<INT4>::TILE / 4096;",
                      "  if (p.M > 0) return;\n"
                      "  constexpr int PER = Strip<INT4>::TILE / 4096;")],
                    None),
    "no_strip_compute": ([("quantized_matmul.cu",
                           "if (kr >= rows) continue;",
                           "if (kr >= rows || p.M > 0) continue;")], None),
    "no_dequant": ([("quantized_matmul.cu", "      fr.build(p, scale,",
                     "      if (p.M < 0) fr.build(p, scale,")], None),
    "no_wgmma": ([("quantized_matmul.cu",
                   "          tc::wgmma_rs_n128<0>(acc, a[h][kk], db, 1);",
                   "          if (p.M < 0)\n"
                   "          tc::wgmma_rs_n128<0>(acc, a[h][kk], db, 1);")],
                 None),
    "tc_stages_3_4": ([("quantized_matmul.cu",
                        "STAGES = INT4 ? 5 : 8;", "STAGES = INT4 ? 3 : 4;")],
                      None),
    "no_x_load": ([("quantized_matmul.cu",
                    "tc::mbar_arrive_tx(bar, Sm::CODE + (lp.x_tma ? H * Sm::XT : 0));",
                    "tc::mbar_arrive_tx(bar, Sm::CODE);"),
                   ("quantized_matmul.cu", "        if (lp.x_tma)\n          for (int h",
                    "        if (lp.x_tma && p.M < 0)\n          for (int h")], None),
    "no_code_load": ([("quantized_matmul.cu",
                       "tc::mbar_arrive_tx(bar, Sm::CODE + (lp.x_tma ? H * Sm::XT : 0));",
                       "tc::mbar_arrive_tx(bar, lp.x_tma ? H * Sm::XT : 0);"),
                      ("quantized_matmul.cu",
                       "        tc::tma_load(tc::smem_u32(sm.code(st)), &lp.wmap,",
                       "        if (p.M < 0) tc::tma_load(tc::smem_u32(sm.code(st)), &lp.wmap,")],
                     None),
    # the strip body's codes by TMA bulk copies (one a code row, completing
    # on a stage's mbarrier) in place of 16-byte cp.async (M <= 16)
    "strip_tma": ([("quantized_matmul.cu",
                    """  auto issue = [&](int t) {
    if (t < steps) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {""",
                    """  __shared__ uint64_t bars[STAGES];
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) tc::mbar_init(bars + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int t) {
    if (t < steps) {
      const int live = min(bk, rows - t * bk);
      if (tid == 0) tc::mbar_arrive_tx(bars + t % STAGES, live * bn);
      if (tid < live)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];\\n" ::"r"(
                tc::smem_u32(smem + (t % STAGES) * SLOT + tid * P)),
            "l"(w + static_cast<size_t>(k_begin + t * bk + tid) * p.Npad +
                n0),
            "r"(bn), "r"(tc::smem_u32(bars + t % STAGES))
            : "memory");
#pragma unroll
      for (int i = 0; i < PER && p.M < 0; ++i) {"""),
                   ("quantized_matmul.cu",
                    "    tc::cp_async_wait<STAGES - 2>();\n",
                    "    tc::mbar_wait(bars + t % STAGES, (t / STAGES) & 1);\n")],
                  None),
    # the wgmma body's codes by 16-byte cp.async from the producer warp,
    # each lane's copies completing on the stage's mbarrier, in place of
    # one TMA box (M > 16)
    "tc_cp_async": ([("quantized_matmul.cu",
                      "tc::mbar_init(sm.full() + st, lp.x_tma ? 1 : 2);",
                      "tc::mbar_init(sm.full() + st, (lp.x_tma ? 1 : 2) + 32);"),
                     ("quantized_matmul.cu",
                      "tc::mbar_arrive_tx(bar, Sm::CODE + (lp.x_tma ? H * Sm::XT : 0));",
                      "tc::mbar_arrive_tx(bar, lp.x_tma ? H * Sm::XT : 0);"),
                     ("quantized_matmul.cu",
                      "        tc::tma_load(tc::smem_u32(sm.code(st)), &lp.wmap, bar, n0, k, p.li);\n",
                      """      }
      for (int c = lane; c < TC_BK * 8; c += 32) {
        const int r = c / 8, ch = c % 8;
        const bool ok = k + r < p.K;
        tc::cp_async16(tc::smem_u32(sm.code(st)) + r * 128 + ((ch ^ (r & 7)) << 4),
                   layer_codes(p) + static_cast<size_t>(ok ? k + r : 0) *
                       p.Npad + n0 + 16 * ch,
                   ok ? 16 : 0);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\\n"
                   ::"r"(tc::smem_u32(bar)) : "memory");
      if (lane == 0) {
""")], None),
    "splits_half": ([], lambda *a: resplit(*a, lambda s: max(1, s // 2))),
    "splits_double": ([], lambda *a: resplit(*a, lambda s: 2 * s)),
    "splits_triple": ([], lambda *a: resplit(*a, lambda s: 3 * s)),
    "no_split": ([], lambda *a: resplit(*a, lambda s: 1)),
    "strip_bn32_whole": ([], lambda base, K, npad, M, gran: base._replace(
        bn=32, splits=1, split_rows=K, grid=(npad // 32, 1), ws_bytes=0)
        if base.body == 0 and K <= 2048 and gran == 16 else None),
}


# paged_attention.cu: name -> (edits, decode plan rule); the rule maps
# decode_plan's split count to the variant's (chip_smoke.decode_resplit)
PAGED = "paged_attention.cu"
PAGED_VARIANTS = {
    "kernel": ([], None),
    "splits_half": ([], lambda s: max(1, s // 2)),
    "splits_double": ([], lambda s: 2 * s),
    "no_split": ([], lambda s: 1),
    "dec_stages2": ([(PAGED, "constexpr int DEC_STAGES = 3;",
                      "constexpr int DEC_STAGES = 2;")], None),
    "dec_stages4": ([(PAGED, "constexpr int DEC_STAGES = 3;",
                      "constexpr int DEC_STAGES = 4;")], None),
    # the decode's ring on a 16-byte boundary only: eight lanes' 16-byte
    # reads of a slot row then straddle two 128-byte lines
    "dec_ring_align16": ([(PAGED, "extern __shared__ __align__(128) "
                           "uint8_t smem[];", "extern __shared__ "
                           "__align__(16) uint8_t smem[];")], None),
    "pf_stages2": ([(PAGED, "constexpr int PF_STAGES = 3;",
                     "constexpr int PF_STAGES = 2;")], None),
    "pf_stages4": ([(PAGED, "constexpr int PF_STAGES = 3;",
                     "constexpr int PF_STAGES = 4;")], None),
    # K/V by cp.async rows through the page table where TMA boxes could be
    "pf_cp_async": ([(PAGED, "constexpr int PF_TMA = 1;",
                      "constexpr int PF_TMA = 0;")], None),
    # one q head a block: each K/V tile loaded (and converted) G times
    "pf_one_head": ([(PAGED, "const int hpb = (p.Hq / p.Hkv) % 2 == 0 ? 2 "
                      ": 1;", "const int hpb = 1;")], None),
    # the producer warp alone gathers and converts (no converter warps), or
    # one producer warpgroup (no setmaxnreg: 168 registers for every thread)
    "pf_producer_converts": ([(PAGED,
                               "constexpr int PF_PRODUCER_WARPS = 8;",
                               "constexpr int PF_PRODUCER_WARPS = 1;")],
                             None),
    "pf_producer_warps4": ([(PAGED, "constexpr int PF_PRODUCER_WARPS = 8;",
                             "constexpr int PF_PRODUCER_WARPS = 4;")], None),
    # diagnostic cuts (their outputs are wrong; only their times count):
    # decode without its math, decode with every copy zero-filled (no
    # device-memory reads), prefill with no conversion of codes
    "dec_no_math": ([(PAGED, "for (int kg = 2 * ks; kg < DEC_CK / 4; "
                      "kg += 2 * KS) {", "for (int kg = 2 * ks; kg < DEC_CK "
                      "/ 4 && p.layer < 0; kg += 2 * KS) {")], None),
    "dec_no_load": ([(PAGED, "            slot >= 0 ? 16 : 0);",
                      "            slot >= 0 && p.layer < 0 ? 16 : 0);")],
                    None),
    "pf_no_convert": ([(PAGED, "for (int idx = pt; idx < 2 * 64 * U; "
                        "idx += PT) {", "for (int idx = pt; idx < 2 * 64 * U "
                        "&& p.layer < 0; idx += PT) {")], None),
}


def resplit(base, K, npad, M, gran, rule):
    """The strip plan ``base`` with its split count changed by ``rule``
    (whole granules: 16 rows, int4 groups), or None for the wgmma body
    (which does not split) and when a split would stage more rows of x
    than the strip takes."""
    if base.body == 1:
        return None
    splits = min(max(1, rule(base.splits)), -(-K // gran))
    rows = -(-(-(-K // splits)) // gran) * gran
    if rows > (1024 if gran != 16 else 2048):
        return None
    splits = -(-K // rows)
    return base._replace(splits=splits, split_rows=rows if splits > 1 else K,
                         grid=(*base.grid[:-1], splits),
                         ws_bytes=4 * splits * M * npad if splits > 1 else 0)


FAMILY_FILES = {"flash_bwd": ("flash_bwd.cu", "flash_tile.cuh", "hopper.cuh"),
                "qmm": ("quantized_matmul.cu", "hopper.cuh"),
                "paged": (PAGED, "flash_tile.cuh", "hopper.cuh")}


def write_variant(name: str, family: str = "flash_bwd") -> str:
    """The variant's sources under OUT/name (OUT/<family>_name for the qmm
    and paged families); returns its directory."""
    edits = {"flash_bwd": lambda: VARIANTS[name],
             "qmm": lambda: QMM_VARIANTS[name][0],
             "paged": lambda: PAGED_VARIANTS[name][0]}[family]()
    d = os.path.join(OUT, name if family == "flash_bwd"
                     else f"{family}_{name}")
    os.makedirs(d, exist_ok=True)
    for f in FAMILY_FILES[family]:
        with open(os.path.join(CSRC, f)) as fh:
            text = fh.read()
        for where, old, new in edits:
            if where == f:
                if old not in text:
                    raise ValueError(f"{name}: {old!r} not in {f}")
                text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    return d


def build(names, family: str = "flash_bwd", parent=None) -> dict:
    """Build every variant at once; returns name -> loaded library. With
    ``parent`` (paged family), the variant ``parent`` is that checkout's
    paged source as it is."""
    from v2pe_tpu_torch.ops import _build

    procs = []
    for name in names:
        if name == "parent":
            d = os.path.join(OUT, "paged_parent")
            os.makedirs(d, exist_ok=True)
            src = os.path.join(parent, "v2pe_tpu_torch", "csrc")
            for f in os.listdir(src):
                if f == PAGED or f.endswith(".cuh"):
                    with open(os.path.join(src, f)) as fi, \
                            open(os.path.join(d, f), "w") as fo:
                        fo.write(fi.read())
        else:
            d = write_variant(name, family)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", os.path.join(d, "lib.so"),
               os.path.join(d, FAMILY_FILES[family][0])]
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
        regs, fn = [], ""
        for ln in lines:  # "<kernel>[<template argument>]: N registers"
            if "Compiling entry function" in ln:
                m = re.search(r"(\w+_kernel\w*?)I?L?i?(\d*)E", ln)
                fn = f"{m.group(1)}<{m.group(2)}>" if m else ln.split()[-1]
            elif "Used" in ln:
                regs.append(f"{fn}: "
                            + ln.split("Used")[1].split(",")[0].strip())
        notes = [ln.strip() for ln in lines
                 if ("spill" in ln and " 0 bytes spill stores" not in ln)
                 or ("wgmma" in ln and "Compiling" not in ln)]
        print(f"variant {name}: registers {regs}; {notes or 'no spills'}",
              flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        if family == "flash_bwd":
            lib.v2pe_flash_bwd_dkv.argtypes = [p] * 12 + tail
            lib.v2pe_flash_bwd_dq.argtypes = [p] * 11 + tail
        elif family == "qmm":
            _build.bind_qdot(lib)
        elif name == "parent":
            lib = ParentPaged(lib)
        else:
            _build.bind_paged(lib)
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


def qmm_forms():
    """(kernel, form, bits, (L, D, N), M) of the quantized products:
    InternVL2-2B's layer products at decode (M = 1, 3), wqkv and w2 at the
    8-tile prompt's last 119-row chunk and its whole 2167 rows, and the
    vocab head at M = 1; int8 and int4."""
    D, I, V, L = 2048, 8192, 92553, 24
    forms = []
    for bits, k2d, kst in ((8, "qdot", "qdot_stacked"),
                           (4, "q4dot", "q4dot_stacked")):
        for M in (1, 3, cs.PREFILL_TAIL, cs.PREFILL_ROWS):
            for name, shape in (("wqkv", (D, 4096)), ("wo", (D, D)),
                                ("w1", (D, I)), ("w2", (I, D))):
                if M > 16 and name in ("wo", "w1"):
                    continue
                forms.append((kst, f"{name}_M{M}", bits, (L, *shape), M))
        forms.append((k2d, "head_M1", bits, (D, V), 1))
    return forms


class ParentPaged:
    """The paged entry points of a checkout from before the split decode
    (no plan, workspace or counters; no layer count for the prefill),
    called with the current wrappers' arguments."""

    def __init__(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.v2pe_paged_decode.argtypes = [p] * 12 + [i] * 13 + [f, p]
        lib.v2pe_paged_prefill.argtypes = [p] * 10 + [i] * 11 + [f, p]
        for fn in (lib.v2pe_paged_decode, lib.v2pe_paged_prefill):
            fn.restype = ctypes.c_int
        self.lib = lib

    def v2pe_paged_decode(self, *a):
        return self.lib.v2pe_paged_decode(*a[:26], a[-1])

    def v2pe_paged_prefill(self, *a):
        return self.lib.v2pe_paged_prefill(*a[:22], a[-1])


PAGED_FORMS = ("decode_fresh_in_pages", "decode_32k_B1_ps128",
               "decode_34165_B1_ps512_bf16", "decode_engine_B8_8k_T1",
               "decode_engine_B8_8k_T5_ps512_bf16",
               "decode_separate_T4_B3_ps128_bf16", "prefill_2048_over_32k",
               "prefill_256_over_served_rows")


HOST_CALLS = 400  # wrapper calls of each library in host_pair


def parent_wrappers(parent: str):
    """The ``ops/paged_attention.py`` of the checkout in ``parent``, loaded
    as a module of its own: its wrappers, which reach their library through
    ``_build.load()`` as this checkout's do."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_paged_attention",
        os.path.join(parent, "v2pe_tpu_torch", "ops", "paged_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_pair(call_a, lib_a, call_b, lib_b):
    """Median host time (us) of one call of ``call_a`` with ``_build.load``
    giving library a and of ``call_b`` with it giving library b, called in
    turns so that both see the same host."""
    import statistics
    import time

    from v2pe_tpu_torch.ops import _build

    own = _build.load
    times = ([], [])
    try:
        for i in range(2 * HOST_CALLS):
            call, lib = ((call_a, lib_a), (call_b, lib_b))[i % 2]
            _build.load = lambda lib=lib: lib
            if i % 64 < 2:
                torch.cuda.synchronize()  # keep the queue short
            t0 = time.perf_counter()
            call()
            times[i % 2].append(time.perf_counter() - t0)
    finally:
        _build.load = own
    torch.cuda.synchronize()
    return tuple(statistics.median(t) * 1e6 for t in times)


def run_paged(args) -> int:
    """The paged family: every variant against the plain version and timed
    at the paged kernels' main forms, beside the library on the K/V
    gathered beforehand."""
    from v2pe_tpu_torch.ops import _build
    from v2pe_tpu_torch.ops import paged_attention as pa

    names = [v for v in args.variants.split(",") if v and v != "none"]
    if "store_apart" in names:
        names.remove("store_apart")
        run_store_apart(args.iters)
        if not names and not args.parent:
            print(cs.card_line())
            return 0
    if args.parent:
        names.append("parent")
    libs = build(names, "paged", args.parent)
    ppa = parent_wrappers(args.parent) if args.parent else None
    own_plan, own_load = pa.decode_plan, _build.load
    if args.sweep:  # the random sweep of #5-#6 through each variant
        try:
            for vname, lib in libs.items():
                print(f"ablate paged sweep {vname}:", flush=True)
                _build.load = lambda lib=lib: lib
                try:
                    cs.phase_paged_sweep()
                except AssertionError as e:
                    print(f"ablate paged sweep {vname} FAILED: {e}",
                          flush=True)
                for _, counters in pa._DECODE_SCRATCH.values():
                    counters.zero_()
        finally:
            _build.load = own_load
        print(cs.card_line())
        return 0
    try:
        for kernel, form, fn, kw in cs.paged_forms(torch.device("cuda"),
                                                   cs.PROBE_PROMPTS):
            if kernel == "paged_store" or not form.startswith(PAGED_FORMS):
                continue
            lib_ms = cs.library_ms(cs.gathered_attention(kernel, kw), 3)
            bound = cs.paged_roof(kernel, kw)
            print(f"ablate paged {form}: bound {bound['bound_ms']:.4f} ms by "
                  f"{bound['bound_by']}; SDPA on the K/V gathered "
                  f"beforehand {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
                  f"; plan {own_plan(*plan_shape(kw))}", flush=True)
            if kernel == "paged_decode" and {"kernel", "parent"} <= set(libs):
                # this checkout's wrapper and library against the parent's
                hk, hp = host_pair(
                    lambda: pa.paged_decode_attention(**kw), libs["kernel"],
                    lambda: ppa.paged_decode_attention(**kw),
                    libs["parent"].lib)
                print(f"ablate paged {form} wrapper host time, this "
                      f"checkout's and the parent's wrapper in turns, median "
                      f"of {HOST_CALLS} each: {hk:.1f} us against "
                      f"{hp:.1f} us", flush=True)
            for vname, lib in libs.items():
                rule = PAGED_VARIANTS.get(vname, ([], None))[1]
                if rule is not None and kernel != "paged_decode":
                    continue
                _build.load = lambda lib=lib: lib
                pa.decode_plan = own_plan if rule is None else (
                    lambda *a, rule=rule: cs.decode_resplit(
                        own_plan(*a), rule(own_plan(*a).splits), a[2], a[3]))
                msg, ok, _ = cs.paged_check(kernel, fn, kw)
                ms = min(cs.time_ms(lambda: fn(**kw), args.iters)
                         for _ in range(3))
                print(f"ablate paged {form} {vname}: {ms:.4f} ms; {msg}"
                      f"{'' if ok else ' FAILED'}", flush=True)
                # a cut variant may leave the split counters raised
                for _, counters in pa._DECODE_SCRATCH.values():
                    counters.zero_()
            pa.decode_plan = own_plan
            del kw
            torch.cuda.empty_cache()
    finally:
        pa.decode_plan, _build.load = own_plan, own_load
    print(cs.card_line())
    return 0


STORE_FORMS = ("decode_fresh_in_pages", "decode_32k_B1_ps128",
               "decode_34165_B1_ps512", "decode_engine_B8_8k_T1",
               "decode_engine_B8_8k_T5")


def run_store_apart(iters: int) -> None:
    """The variant ``store_apart``: at each decode form of STORE_FORMS, #5
    with the store riding in its launch against #5 without it plus the
    standalone #4 (T launches of it, the t-th at lengths + t, for a form of
    T fresh tokens), from the same pool: outputs and pools bit for bit
    equal; device times (best of three, in turns apart, fused, fused,
    apart; #5 and #4 alone beside); the median host time of one call of
    each arm, called in turns."""
    import statistics
    import time

    from v2pe_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(5)
    for kernel, form, fn, kw in cs.paged_forms(torch.device("cuda"),
                                               cs.PROBE_PROMPTS):
        if not form.startswith(STORE_FORMS):
            continue
        B, T, _, D = kw["q"].shape
        Hkv = kw["k_pages"].shape[1]
        if kw.get("k_new") is None:
            kw.update(k_new=torch.randn((B, T, Hkv, D), generator=g,
                                        device="cuda", dtype=kw["q"].dtype),
                      v_new=torch.randn((B, T, Hkv, D), generator=g,
                                        device="cuda", dtype=kw["q"].dtype))
        names = [n for n in ("k_pages", "v_pages", "k_scales", "v_scales")
                 if kw.get(n) is not None]
        pool = {n: kw[n] for n in names}
        tables = dict(page_table=kw["page_table"], layer=kw["layer"])
        # the standalone store's arguments, one set a fresh token
        each = [dict(k_new=kw["k_new"][:, t:t + 1].contiguous(),
                     v_new=kw["v_new"][:, t:t + 1].contiguous(),
                     lengths=(kw["lengths"] + t).contiguous())
                for t in range(T)]
        decode = lambda: pa.paged_decode_attention(**kw)

        def store():
            for e in each:
                pa.store_fresh_token(**e, **pool, **tables)

        def apart():
            if kw.get("fresh_in_pages"):  # store, then attend
                store()
                return decode()
            out = decode()
            store()
            return out

        fused = lambda: pa.paged_decode_attention(**kw, store=True)
        before = {n: t.clone() for n, t in pool.items()}
        got = []
        for arm in (apart, fused):
            for n in names:
                kw[n].copy_(before[n])
            with cs.nan_empty():
                out = arm()
            torch.cuda.synchronize()
            got.append((out, {n: kw[n].clone() for n in names}))
        same = all(torch.equal(a, b) for a, b in zip(got[0][0], got[1][0])) \
            and all(torch.equal(got[0][1][n], got[1][1][n]) for n in names)
        del got, before
        ms = {"apart": [], "fused": []}
        for name in ("apart", "fused", "fused", "apart"):
            arm = apart if name == "apart" else fused
            ms[name].append(min(cs.time_ms(arm, iters) for _ in range(3)))
        t_dec = min(cs.time_ms(decode, iters) for _ in range(3))
        t_st = min(cs.time_ms(store, iters) for _ in range(3))
        host = ([], [])
        for i in range(2 * HOST_CALLS):
            if i % 64 < 2:
                torch.cuda.synchronize()  # keep the queue short
            t0 = time.perf_counter()
            (apart, fused)[i % 2]()
            host[i % 2].append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        h_apart, h_fused = (statistics.median(h) * 1e6 for h in host)
        fz, ap = min(ms["fused"]), min(ms["apart"])
        print(f"ablate store_apart {form}: fused {fz:.4f} ms (runs "
              f"{ms['fused']}), apart {ap:.4f} ms (runs {ms['apart']}): #5 "
              f"alone {t_dec:.4f} ms + {T} x #4 {t_st:.4f} ms; the store "
              f"adds {fz - t_dec:.4f} ms inside #5; host time a call, "
              f"median of {HOST_CALLS} each in turns: fused {h_fused:.1f} "
              f"us, apart {h_apart:.1f} us; outputs and pools bit for bit "
              f"equal {same}{'' if same else ' FAILED'}", flush=True)
        del kw, pool, each
        torch.cuda.empty_cache()


def run_e2e(args) -> int:
    """The e2e family: ``chip_smoke.py --e2e`` through the parent's package
    and this checkout's, in turns, one process each."""
    import json

    if not args.parent:
        raise SystemExit("--family e2e needs --parent DIR")
    runs = {"parent": [], "this": []}
    for arm in ("parent", "this", "this", "parent"):
        cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--e2e"]
        if arm == "parent":
            cmd += ["--root", args.parent]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-4000:], done.stderr[-4000:], flush=True)
            raise RuntimeError(f"chip_smoke.py --e2e ({arm}) failed")
        line = next(ln for ln in reversed(done.stdout.splitlines())
                    if ln.startswith('{"e2e"'))
        runs[arm].append(json.loads(line)["e2e"])
        print(f"ablate e2e {arm}: {line}", flush=True)
    for key in runs["this"][0]:
        print(f"ablate e2e {key}: parent {[r[key] for r in runs['parent']]}"
              f", this checkout {[r[key] for r in runs['this']]}",
              flush=True)
    print(cs.card_line())
    return 0


def plan_shape(kw):
    """decode_plan's arguments at a form's shapes."""
    B, T, Hq, _ = kw["q"].shape
    Hkv, ps = kw["k_pages"].shape[1], kw["k_pages"].shape[3]
    return B, Hkv, kw["page_table"].shape[1], ps, T, Hq // Hkv


def run_qmm(args) -> int:
    """The qmm family: every variant against the plain version and timed,
    form by form, beside F.linear on a bf16 weight of the same shape."""
    import itertools

    import torch.nn.functional as F

    from v2pe_tpu_torch.ops import _build
    from v2pe_tpu_torch.ops import quantized_matmul as qm

    libs = build(args.variants.split(","), "qmm")
    own_plan, own_load = qm.launch_plan, _build.load
    g = torch.Generator(device="cuda").manual_seed(5)
    try:
        for kernel, form, bits, shape, M in qmm_forms():
            *lead, D, N = shape
            w = cs._random_weight(bits, shape, g, "cuda")
            dense = torch.empty((*lead, N, D), dtype=torch.bfloat16,
                                device="cuda").normal_(0, 0.02, generator=g)
            x = torch.randn((M, D), generator=g, device="cuda").to(
                torch.bfloat16)
            odt = torch.float32 if not lead else torch.bfloat16
            layers = itertools.cycle(range(lead[0])) if lead \
                else itertools.repeat(None)
            if lead:
                run = lambda: qm.quantized_dot_stacked(x, w, next(layers),
                                                       odt)
                want = qm.quantized_dot_stacked_torch(x, w, 0, odt).float()
                first = lambda: qm.quantized_dot_stacked(x, w, 0, odt)
                lin = lambda: F.linear(x, dense[next(layers)])
            else:
                run = first = lambda: qm.quantized_dot(x, w, odt)
                want = qm.quantized_dot_torch(x, w, odt).float()
                lin = lambda: F.linear(x, dense)
            base = own_plan(M, D, w.payload.shape[-1],
                            getattr(w, "group_size", 0), bits == 4)
            lib_ms = min(cs.time_ms(lin, args.iters) for _ in range(2))
            print(f"ablate qmm int{bits} {form}: F.linear {lib_ms:.4f} ms; "
                  f"plan {base}", flush=True)
            for vname, lib in libs.items():
                rule = QMM_VARIANTS[vname][1]
                _build.load = lambda lib=lib: lib
                plan = None if rule is None else rule(
                    base, D // 2 if bits == 4 else D, w.payload.shape[-1], M,
                    w.group_size if bits == 4 else 16)
                if rule is not None and plan is None:
                    print(f"ablate qmm int{bits} {form} {vname}: skipped")
                    continue
                qm.launch_plan = own_plan if plan is None \
                    else lambda *a, plan=plan: plan
                with cs.nan_empty():
                    got = first().float()
                    again = first().float()
                torch.cuda.synchronize()
                rel = ((got - want).abs().max() / want.abs().max()).item()
                same = bool(torch.equal(got, again))
                ms = min(cs.time_ms(run, args.iters) for _ in range(3))
                host = cs.time_ms(run, args.iters, behind_spin=False)
                print(f"ablate qmm int{bits} {form} {vname}: {ms:.4f} ms "
                      f"({ms / lib_ms:.2f}x F.linear), back to back "
                      f"{host:.4f} ms; max|kernel-plain|/max|plain| "
                      f"{rel:.2e} (tol {cs.QDOT_TOL[odt]:.1e}); repeat "
                      f"bitwise equal {same}", flush=True)
                # a cut variant (no_split_handshake) leaves the split
                # counters raised: the next variant starts from zeros
                qm._COUNTERS.clear()
            qm.launch_plan = own_plan
            del w, dense, x
            torch.cuda.empty_cache()
    finally:
        qm.launch_plan, _build.load = own_plan, own_load
    print(cs.card_line())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", default="flash_bwd",
                    choices=("flash_bwd", "qmm", "paged", "e2e"))
    ap.add_argument("--variants", default=None)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--parent", default=None,
                    help="paged family: a checkout whose paged source is "
                    "timed as the variant 'parent'")
    ap.add_argument("--sweep", action="store_true",
                    help="paged family: only the random sweep of #5-#6 "
                    "(chip_smoke.phase_paged_sweep) through each variant")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_ablate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    if args.variants is None:
        args.variants = ",".join({"flash_bwd": VARIANTS, "qmm": QMM_VARIANTS,
                                  "paged": [*PAGED_VARIANTS, "store_apart"],
                                  "e2e": []}[args.family])
    if args.family == "e2e":
        return run_e2e(args)
    if args.family == "qmm":
        return run_qmm(args)
    if args.family == "paged":
        return run_paged(args)
    from v2pe_tpu_torch.ops import flash_bwd, flash_fwd

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
