// The tile machinery of the forward flash-attention kernels for NVIDIA
// Hopper (sm_90a), shared by flash_fwd.cu (one K/V sequence per query tile)
// and ring_fused_fwd.cu (the K/V chunks of every rank of a ring, one after
// another, per query tile). Both replace the loop body of a Pallas TPU
// kernel: v2pe_tpu/ops/flash_pallas.py:_kernel and, per hop,
// v2pe_tpu/parallel/ring_fused.py:_kernel. The operand type follows the
// input type; there are two tiles. The bf16 backward (flash_bwd.cu) builds
// its own consumers on the same staging, producer walk, barriers and wgmma
// helpers (the walk also runs over query tiles for dk/dv: WALK_Q).
//
// bf16 q/k/v: the tensor-core tile (namespace tc), with the rounding points
// of the Pallas kernel's precision="bf16all": bf16 operands, fp32
// accumulators; q rotated in fp32 from the fp32 ids and rounded once to
// bf16 (k too, with rope_k); P rounded to bf16 for the PV product only; m, l
// and the accumulator in fp32, l summing the unrounded fp32 e. One
// difference by design: the softmax scale multiplies the fp32 scores, as
// FlashAttention does, instead of q before its rounding, so unrotated bf16
// inputs give exactly the fp32 scores.
//
//   One block owns one (batch row, q head, 64-row query tile): one consumer
//   warpgroup (warps 0-3) and one producer warp (warp 4), 160 threads, about
//   84 KB of shared memory at D 128, so two blocks share an SM and one's
//   softmax overlaps the other's products. Query tiles are launched heaviest
//   first (the slowest grid axis counts down), since the main forms have
//   only 2-4 waves on 132 SMs. The query tile is staged once, rotated and
//   rounded, in the 128-byte-swizzled layout wgmma reads. A head is stored
//   as whole 64-column blocks (DP columns: 64 for D <= 64, 128 for D 96 and
//   128) so that one swizzle serves every D. No product sums over a pad
//   column: QK^T (and the backward's dO V^T) runs D / 16 k-steps, and in the
//   products whose N is the head (PV, and the backward's dQ, dK, dV) a pad
//   column of the B tile feeds only an accumulator column past D, which is
//   never stored. So the pads may hold anything (at D 96 a K/V box reads
//   the next head's first 32 columns, zeros past the last head); D 96 runs
//   PV at n128, a quarter of its product on pad columns, and its consumers
//   hold D 128's 64 accumulators a thread (167 registers, CUDA 12.8).
//
//   K/V tiles of 64 keys reach a ring of STAGES = 2 shared-memory slots by
//   TMA: one thread issues a 64-row x 64-column box per 64 stored columns
//   of k and of v, through tensor maps encoded on the host (k and v viewed as
//   (Hkv*D, S, B); boxes past S arrive as zeros, so a ragged tail never
//   holds stale data) in the 128-byte swizzle that the wgmma descriptors
//   name; a full/empty mbarrier pair guards each slot, the full one
//   counting the boxes' bytes. The producer alone decides which tiles are
//   live, reading the ids of 4 tiles at a time: a K/V tile is skipped
//   before any load of k or v when the min/max of its segment ids and
//   positions show that no query of the tile can attend any of its keys
//   (the causal upper triangle of a packed prefill, whose positions need
//   not be arange, and the dead half of a zigzag ring's hops); a tile in
//   which every (query, key) pair is live is marked FULL and runs with no
//   mask (the Pallas kernel's full/boundary split); the last slot it hands
//   over says END. So producer and consumers walk one sequence of live
//   tiles, and the producer runs as many tiles ahead as there are slots.
//   With rope_k the producer warp stages K itself, rotated in fp32 and
//   rounded once (not on a main path).
//
//   The consumers: S = Q K^T by wgmma m64n64k16 with Q and K (K-major) from
//   shared memory; the scale, and on BOUNDARY tiles the mask from the ids in
//   the slot, applied on the accumulator fragment; the online softmax in
//   registers (each row's max and sum over the four lanes that share it);
//   then O = O corr + P V by wgmma m64n(DP)k16 with P converted from the score
//   fragment to bf16 in registers as the A operand and V read from shared
//   memory through the descriptor's transpose bit (no transposed copy).
//
//   What bounds it: the tensor cores' bf16 rate at these shapes (about 300
//   operations per byte of q, k, v and out), and it runs well below it: a
//   warpgroup waits for its own products before the softmax, so the tensor
//   cores overlap only with the other block(s) on the SM (two at D 128,
//   three at D 64; a third K/V slot did not help). What would come next:
//   issue the next tile's QK^T before this tile's softmax (a second score
//   fragment), and two consumer warpgroups sharing each K/V tile.
//
// fp32 q/k/v: the CUDA-core tile, the counterpart of precision="fp32" and
// exact to fp32 rounding: one 256-thread block owns one 64-row query tile of
// one head, K/V tiles of 64 keys are staged in shared memory as fp32, the
// 64x64 scores and the online-softmax update run in fp32 FMAs from shared
// memory, and the output accumulator stays in registers (4 rows x D/16
// columns per thread). Bound by shared-memory bandwidth and the CUDA cores.
// It skips dead tiles by the same min/max test.
//
// Both: the max is clamped at -1e30/2, so masked scores (-1e30) underflow
// exp to exactly 0 and a fully masked row ends with l = 0, out 0 and lse
// -1e30. Rotary: cos/sin from sincosf of the fp32 angle id * inv_freq[i],
// inv_freq passed in by the wrapper (the table the plain version uses). Not
// built with --use_fast_math: angles reach the context length in radians,
// where __sinf/__cosf lose accuracy.
//
// The generic Hopper helpers (swizzle, descriptors, mbarriers, TMA, wgmma)
// are in hopper.cuh, shared with quantized_matmul.cu.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ------------------------------------------------------------------------
// The fp32 tile: CUDA-core FMAs, K/V staged by the whole block.
// ------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 x 16 threads; thread (ty, tx) owns rows
                              // ty + 16r and columns tx + 16c of each tile
constexpr float NEG_INF = -1e30f;


template <int D>
constexpr int smem_floats() {
  // sQ, sK (rows padded by 1 float against bank conflicts), sV, sS, and
  // the per-row m, l, corr
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ;
}

template <int D>
constexpr size_t smem_bytes() {
  return smem_floats<D>() * sizeof(float) + (2 * BQ + 2 * BK) * sizeof(int);
}

// The block's dynamic shared memory, carved up.
template <int D>
struct Smem {
  static constexpr int LDQ = D + 1, LDK = D + 1, LDS = BK + 1;
  float* q;     // BQ x LDQ, pre-scaled (and rotated) q
  float* k;     // BK x LDK
  float* v;     // BK x D
  float* s;     // BQ x LDS, scores, then probabilities
  float* m;     // running max per row
  float* l;     // running sum per row
  float* corr;  // this tile's rescale factor per row
  int* seg_q;
  int* pos_q;
  int* seg_k;
  int* pos_k;
  __device__ explicit Smem(float* base) {
    q = base;
    k = q + BQ * LDQ;
    v = k + BK * LDK;
    s = v + BK * D;
    m = s + BQ * LDS;
    l = m + BQ;
    corr = l + BQ;
    seg_q = reinterpret_cast<int*>(corr + BQ);
    pos_q = seg_q + BQ;
    seg_k = pos_q + BQ;
    pos_k = seg_k + BK;
  }
};

// Stage rows [row0, row0 + 64) of head h of one batch row x (S,H,D) into dst
// (fp32, row stride ld), rotated by the V2PE rotary at rope[s] when rope (the
// batch row's (S,) ids) is given, times mul. Rows past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* x,
                                          int row0, int S, int H, int h,
                                          const float* rope,
                                          const float* inv_freq, float mul) {
  constexpr int HALF = D / 2;
  for (int idx = threadIdx.x; idx < 64 * HALF; idx += THREADS) {
    const int r = idx / HALF, d = idx % HALF, s = row0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (s < S) {
      const float* src = x + (static_cast<size_t>(s) * H + h) * D;
      x1 = src[d];
      x2 = src[d + HALF];
      if (rope != nullptr) {
        // x * cos + rotate_half(x) * sin, with rotate_half = [-x2, x1]
        float sn, cs;
        sincosf(rope[s] * inv_freq[d], &sn, &cs);
        const float y1 = x1 * cs - x2 * sn;
        const float y2 = x2 * cs + x1 * sn;
        x1 = y1;
        x2 = y2;
      }
    }
    dst[r * ld + d] = x1 * mul;
    dst[r * ld + d + HALF] = x2 * mul;
  }
}

// Min/max of the query tile's valid rows (each thread holds the same).
struct QSummary {
  int sq_min, sq_max, pq_max;
};

// Stage the query tile [q0, q0 + 64) of head h: q (one batch row, (Sq,Hq,D))
// times scale, its segment ids and positions ((Sq,) of the batch row; rows
// past Sq get segment 0 and position -1), and the empty softmax state.
template <int D>
__device__ __forceinline__ QSummary load_q(const Smem<D>& sm, const float* q,
                                           const int* seg_q, const int* pos_q,
                                           const float* rope_q,
                                           const float* inv_freq, int q0,
                                           int Sq, int Hq, int h,
                                           float scale) {
  const int tid = threadIdx.x;
  load_tile<D>(sm.q, Smem<D>::LDQ, q, q0, Sq, Hq, h, rope_q, inv_freq,
                  scale);
  if (tid < BQ) {
    const int s = q0 + tid;
    const bool ok = s < Sq;
    sm.seg_q[tid] = ok ? seg_q[s] : 0;
    sm.pos_q[tid] = ok ? pos_q[s] : -1;
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  __syncthreads();

  const int nq = min(BQ, Sq - q0);
  QSummary qs{INT_MAX, INT_MIN, INT_MIN};
  for (int r = 0; r < nq; ++r) {
    qs.sq_min = min(qs.sq_min, sm.seg_q[r]);
    qs.sq_max = max(qs.sq_max, sm.seg_q[r]);
    qs.pq_max = max(qs.pq_max, sm.pos_q[r]);
  }
  return qs;
}

// Attend the staged query tile to one K/V sequence: k/v (one batch row,
// (Sk,Hkv,D)), head hk, segment ids and positions (Sk,). Updates m, l in
// shared memory and acc in registers.
template <int D>
__device__ __forceinline__ void sweep_kv(const Smem<D>& sm, const QSummary& qs,
                                         float (&acc)[4][D / 16],
                                         const float* k, const float* v,
                                         const int* seg_k,
                                         const int* pos_k, const float* rope_k,
                                         const float* inv_freq, int Sk,
                                         int Hkv, int hk, int causal) {
  constexpr int LDQ = Smem<D>::LDQ, LDK = Smem<D>::LDK, LDS = Smem<D>::LDS;
  constexpr int NC = D / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float* sQ = sm.q;
  float* sK = sm.k;
  float* sV = sm.v;
  float* sS = sm.s;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    __syncthreads();  // the previous tile's readers are done with smem
    if (tid < BK) {
      const bool ok = tid < nk;
      sm.seg_k[tid] = ok ? seg_k[k0 + tid] : 0;
      sm.pos_k[tid] = ok ? pos_k[k0 + tid] : (1 << 30);
    }
    __syncthreads();

    int sk_min = INT_MAX, sk_max = INT_MIN, pk_min = INT_MAX;
    for (int j = 0; j < nk; ++j) {
      sk_min = min(sk_min, sm.seg_k[j]);
      sk_max = max(sk_max, sm.seg_k[j]);
      pk_min = min(pk_min, sm.pos_k[j]);
    }
    const bool dead = qs.sq_max < sk_min || sk_max < qs.sq_min ||
                      (sk_min == 0 && sk_max == 0) ||
                      (qs.sq_min == 0 && qs.sq_max == 0) ||
                      (causal && qs.pq_max < pk_min);
    if (dead) continue;  // uniform across the block

    load_tile<D>(sK, LDK, k, k0, Sk, Hkv, hk, rope_k, inv_freq, 1.f);
    load_tile<D>(sV, D, v, k0, Sk, Hkv, hk, nullptr, nullptr, 1.f);
    __syncthreads();

    // Scores: a 4x4 register tile per thread, masked into sS.
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sQ[(ty + 16 * r) * LDQ + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kk[c] = sK[(tx + 16 * c) * LDK + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], kk[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
      const int sg = sm.seg_q[row], pq = sm.pos_q[row];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const bool ok = sg != 0 && sg == sm.seg_k[col] &&
                        (!causal || pq >= sm.pos_k[col]);
        sS[row * LDS + col] = ok ? s[r][c] : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax: four neighbouring threads share a row, 16 keys each.
    {
      const int row = tid >> 2, part = tid & 3;
      float* srow = sS + row * LDS + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, srow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = sm.m[row];
      const float m_new = fmaxf(fmaxf(m_prev, mx), NEG_INF / 2);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float e = expf(srow[j] - m_new);
        srow[j] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        sm.corr[row] = corr;
        sm.l[row] = sm.l[row] * corr + sum;
        sm.m[row] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float corr = sm.corr[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pr[4], vv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = sS[(ty + 16 * r) * LDS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
    }
  }
}

// Normalize and write the tile: out (one batch row, (Sq,Hq,D)) and lse
// (this batch row's and head's (Sq,)), fp32. A row that attended
// nothing gives out 0 and lse -1e30.
template <int D>
__device__ __forceinline__ void write_out(const Smem<D>& sm,
                                          const float (&acc)[4][D / 16],
                                          float* out, float* lse, int q0,
                                          int Sq, int Hq, int h) {
  constexpr int NC = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r, s = q0 + row;
    if (s >= Sq) continue;
    const float l = sm.l[row];
    const float l_safe = l > 0.f ? l : 1.f;
    float* o = out + (static_cast<size_t>(s) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = acc[r][c] / l_safe;
    if (tx == 0) lse[s] = l > 0.f ? sm.m[row] + logf(l_safe) : NEG_INF;
  }
}

// ------------------------------------------------------------------------
// The bf16 tile: wgmma on the tensor cores, K/V fed asynchronously.
// ------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 64;           // query rows per block: one wgmma M
constexpr int BK = 64;           // keys per K/V tile: the QK^T product's N
constexpr int CONSUMERS = 128;   // one warpgroup (warps 0-3)
constexpr int THREADS = CONSUMERS + 32;  // + one producer warp (warp 4)
constexpr int BOUNDARY = 0, FULL = 1, END = 2;  // what a stage carries
constexpr int STAGES = 2;        // K/V tiles in flight
constexpr int LOOK = 4;          // K/V tiles whose ids are loaded at once

constexpr uint32_t BOX_BYTES = 64 * 128;  // one TMA box: 64 rows x 128 B

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db, 1);
  } else {
    wgmma_rs_n128(d, a, db, 1);
  }
}

// The V2PE rotary of one pair (x1, x2) = (x[d], x[d + D/2]) by an fp32
// angle: x cos + rotate_half(x) sin, each product and sum rounded on its
// own (no fused multiply-add), as the plain version computes it, so that
// the one bf16 rounding that follows sees the same fp32 value.
__device__ __forceinline__ void rotate(float& x1, float& x2, float angle) {
  float sn, cs;
  sincosf(angle, &sn, &cs);
  const float y1 = __fadd_rn(__fmul_rn(x1, cs), __fmul_rn(-x2, sn));
  const float y2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
  x1 = y1;
  x2 = y2;
}

// The block's dynamic shared memory: F tiles staged once (the forward: the
// query tile), STAGES pairs of tiles that the producer streams (the forward:
// K and V), each 64 rows of DP bf16 columns, swizzled, 1024-byte aligned;
// per stage the streamed tiles' ids and X more 32-bit words; the staged
// tile's ids, and the full/empty barrier pair of each stage.
template <int D, int F = 1, int X = 0>
struct Smem {
  static_assert(D % 16 == 0 && D <= 128, "head dims of 16-128 by 16");
  static constexpr int DP = D <= 64 ? 64 : 128;  // stored columns: whole
                                                 // 64-column blocks
  static constexpr int TILE = 64 * DP * 2;    // bytes of one tile
  static constexpr int SLOT = 2 * BK + X;     // 32-bit words of one stage
  static constexpr int INTS = STAGES * SLOT + 2 * BQ + STAGES;
  static constexpr size_t BYTES =
      1024 + TILE * (F + 2 * STAGES) + INTS * 4 + 8 + 2 * STAGES * 8;
  uint8_t* base;
  __device__ explicit Smem(uint8_t* raw) {
    base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  }
  __device__ bf16* q() const { return reinterpret_cast<bf16*>(base); }
  __device__ bf16* fixed(int i) const {
    return reinterpret_cast<bf16*>(base + TILE * i);
  }
  __device__ bf16* k(int st) const {
    return reinterpret_cast<bf16*>(base + TILE * (F + st));
  }
  __device__ bf16* v(int st) const {
    return reinterpret_cast<bf16*>(base + TILE * (F + STAGES + st));
  }
  __device__ int* ints() const {
    return reinterpret_cast<int*>(base + TILE * (F + 2 * STAGES));
  }
  __device__ int* seg_k(int st) const { return ints() + st * SLOT; }
  __device__ int* pos_k(int st) const { return ints() + st * SLOT + BK; }
  __device__ float* extra(int st) const {
    return reinterpret_cast<float*>(ints() + st * SLOT + 2 * BK);
  }
  __device__ int* seg_q() const { return ints() + STAGES * SLOT; }
  __device__ int* pos_q() const { return seg_q() + BQ; }
  __device__ int* flag() const { return pos_q() + BQ; }
  __device__ uint64_t* full() const {
    return reinterpret_cast<uint64_t*>(
        (reinterpret_cast<uintptr_t>(ints() + INTS) + 7) & ~uintptr_t(7));
  }
  __device__ uint64_t* empty() const { return full() + STAGES; }
};

// Stage the 8 pairs (x[d0 + i], x[d0 + HALF + i]) of row r of a 64-row
// tile from src (the row's D values; zeros when !valid) into the swizzled
// tile dst by 16-byte loads and stores, rotated by angle id * inv_freq[d0 +
// i] and rounded once to bf16 when inv_freq is given.
template <int D>
__device__ __forceinline__ void stage_pairs(bf16* dst, int r, int d0,
                                            bool valid, const bf16* src,
                                            float id, const float* inv_freq) {
  constexpr int HALF = D / 2;
  uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
  if (valid) {
    lo = *reinterpret_cast<const uint4*>(src + d0);
    hi = *reinterpret_cast<const uint4*>(src + d0 + HALF);
    if (inv_freq != nullptr) {
      bf16* a = reinterpret_cast<bf16*>(&lo);
      bf16* b = reinterpret_cast<bf16*>(&hi);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float x1 = __bfloat162float(a[i]), x2 = __bfloat162float(b[i]);
        rotate(x1, x2, id * inv_freq[d0 + i]);
        a[i] = __float2bfloat16_rn(x1);
        b[i] = __float2bfloat16_rn(x2);
      }
    }
  }
  *reinterpret_cast<uint4*>(dst + swz(r, d0)) = lo;
  *reinterpret_cast<uint4*>(dst + swz(r, d0 + HALF)) = hi;
}

// Stage rows [row0, row0 + 64) of head h of one batch row x (S,H,D) into
// the swizzled tile dst (rows past S zero), rotated in fp32 by the V2PE
// rotary at rope (the row's (S,) ids, when given) and rounded once to bf16.
// All THREADS of the block take part.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* x,
                                           const float* rope,
                                           const float* inv_freq, int row0,
                                           int S, int H, int h) {
  constexpr int HALF = D / 2;
  for (int idx = threadIdx.x; idx < BQ * (HALF / 8); idx += THREADS) {
    const int r = idx / (HALF / 8), d0 = idx % (HALF / 8) * 8, s = row0 + r;
    stage_pairs<D>(dst, r, d0, s < S,
                   x + (static_cast<size_t>(s) * H + h) * D,
                   rope != nullptr ? rope[min(s, S - 1)] : 0.f,
                   rope != nullptr ? inv_freq : nullptr);
  }
}

// Set-up by all THREADS of the block, before the roles split: the barriers
// (full: the producer warp's 32 lanes arrive; empty: the 128 consumer
// threads), the query tile [q0, q0 + 64) of head h rotated in fp32 by the
// V2PE rotary at rope_q (when given) and rounded once to bf16, its ids (rows
// past Sq: segment 0, position -1) and, for D < 64, zeros in the K/V
// columns no load writes. Ends with the block's one __syncthreads. (The
// backward stages a key tile here in the query tile's place.)
template <int D, int F, int X>
__device__ __forceinline__ void setup(const Smem<D, F, X>& sm, const bf16* q,
                                      const int* seg_q, const int* pos_q,
                                      const float* rope_q,
                                      const float* inv_freq, int q0, int Sq,
                                      int Hq, int h) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(sm.full() + st, 32);
      mbar_init(sm.empty() + st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (D < 64) {
    uint32_t* kv = reinterpret_cast<uint32_t*>(sm.k(0));
    for (int i = tid; i < 2 * STAGES * Smem<D, F, X>::TILE / 4; i += THREADS)
      kv[i] = 0u;
  }
  stage_rows<D>(sm.q(), q, rope_q, inv_freq, q0, Sq, Hq, h);
  if (tid < BQ) {
    const int s = q0 + tid;
    const bool ok = s < Sq;
    sm.seg_q()[tid] = ok ? seg_q[s] : 0;
    sm.pos_q()[tid] = ok ? pos_q[s] : -1;
  }
  fence_proxy_async();
  __syncthreads();
}

// The producer warp's view of the query tile: min/max over its valid rows.
struct QRange {
  int sq_min, sq_max, pq_min, pq_max;
};

template <int D, int F, int X>
__device__ __forceinline__ QRange q_range(const Smem<D, F, X>& sm, int nq) {
  const int lane = threadIdx.x & 31;
  QRange qr{INT_MAX, INT_MIN, INT_MAX, INT_MIN};
  for (int r = lane; r < nq; r += 32) {
    qr.sq_min = min(qr.sq_min, sm.seg_q()[r]);
    qr.sq_max = max(qr.sq_max, sm.seg_q()[r]);
    qr.pq_min = min(qr.pq_min, sm.pos_q()[r]);
    qr.pq_max = max(qr.pq_max, sm.pos_q()[r]);
  }
  qr.sq_min = __reduce_min_sync(0xffffffffu, qr.sq_min);
  qr.sq_max = __reduce_max_sync(0xffffffffu, qr.sq_max);
  qr.pq_min = __reduce_min_sync(0xffffffffu, qr.pq_min);
  qr.pq_max = __reduce_max_sync(0xffffffffu, qr.pq_max);
  return qr;
}

// The ring position of the producer (and, separately, of the consumers).
struct Pipe {
  int st = 0, ph = 0;
  __device__ void advance() {
    if (++st == STAGES) {
      st = 0;
      ph ^= 1;
    }
  }
};

// Producer warp: walk the K/V tiles of one sequence (batch row b of the
// (Hkv*D, Sk, B) views kmap/vmap of k/v at head hk; that row's ids (Sk,)),
// skip the dead ones from the min/max of their ids before touching k or v,
// and hand each live tile to the consumers through the ring: ids and the
// tile's kind (FULL: every pair is live, no mask; else BOUNDARY) by
// st.shared, K and V by TMA, one 64 x 64 box per 64 stored columns, in the
// 128-byte swizzle (rows past Sk arrive as zeros). The producer never waits
// for its own loads: it runs up to STAGES tiles ahead. With rope_k (k: batch
// row b's (Sk,Hkv,D)), K is instead loaded by the warp, rotated in fp32 and
// rounded once to bf16 on its way to shared memory.
//
// WALK_Q (the backward's dk/dv): the staged tile holds keys and the walk
// runs over query tiles instead: kmap/vmap are q and do viewed as
// (Hq*D, Sq, B) at head hk, seg_k/pos_k/Sk the query ids, the causal tests
// are turned round (a query sees a key at or before it), and the stage's
// X = 128 extra words carry the 64 rows' lse and then di (the (Sq,) rows of
// this batch row and head; 0 past Sq).
template <int D, bool WALK_Q = false, int F, int X>
__device__ __forceinline__ void produce(const Smem<D, F, X>& sm, Pipe& pp,
                                        const QRange& qr,
                                        const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, int b,
                                        const bf16* k, const int* seg_k,
                                        const int* pos_k, const float* rope_k,
                                        const float* inv_freq, int Sk,
                                        int Hkv, int hk, int causal,
                                        const float* lse = nullptr,
                                        const float* di = nullptr) {
  static_assert(!WALK_Q || X >= 2 * BQ, "WALK_Q stages lse and di");
  constexpr int HALF = D / 2, BOXES = Smem<D, F, X>::DP / 64;
  const int lane = threadIdx.x & 31;
  int sg[LOOK][2], ps[LOOK][2];
  for (int k0 = 0, t = 0; k0 < Sk; k0 += BK, t = (t + 1) % LOOK) {
    if (t == 0) {  // the ids of the next LOOK tiles, all loads in flight
#pragma unroll
      for (int u = 0; u < LOOK; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + u * BK + lane + 32 * e;
          sg[u][e] = j < Sk ? seg_k[j] : 0;
          ps[u][e] = j < Sk ? pos_k[j] : (1 << 30);
        }
    }
    const int nk = min(BK, Sk - k0);
    int sk_min = INT_MAX, sk_max = INT_MIN, pk_min = INT_MAX, pk_max = INT_MIN;
    int tile_sg[2], tile_ps[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int u = 0; u < LOOK; ++u)  // constant indices: registers
        if (u == t) {
          tile_sg[e] = sg[u][e];
          tile_ps[e] = ps[u][e];
        }
      if (lane + 32 * e < nk) {
        sk_min = min(sk_min, tile_sg[e]);
        sk_max = max(sk_max, tile_sg[e]);
        pk_min = min(pk_min, tile_ps[e]);
        pk_max = max(pk_max, tile_ps[e]);
      }
    }
    sk_min = __reduce_min_sync(0xffffffffu, sk_min);
    sk_max = __reduce_max_sync(0xffffffffu, sk_max);
    pk_min = __reduce_min_sync(0xffffffffu, pk_min);
    pk_max = __reduce_max_sync(0xffffffffu, pk_max);
    // the queries' and the keys' position ranges
    const int q_lo = WALK_Q ? pk_min : qr.pq_min;
    const int q_hi = WALK_Q ? pk_max : qr.pq_max;
    const int k_lo = WALK_Q ? qr.pq_min : pk_min;
    const int k_hi = WALK_Q ? qr.pq_max : pk_max;
    const bool dead = qr.sq_max < sk_min || sk_max < qr.sq_min ||
                      (sk_min == 0 && sk_max == 0) ||
                      (qr.sq_min == 0 && qr.sq_max == 0) ||
                      (causal && q_hi < k_lo);
    if (dead) continue;  // uniform across the warp
    const bool full = nk == BK && sk_min == sk_max && qr.sq_min == qr.sq_max &&
                      sk_min == qr.sq_min && sk_min != 0 &&
                      (!causal || q_lo >= k_hi);
    float rows[WALK_Q ? 4 : 1];  // lse and di of the walked rows
    if constexpr (WALK_Q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + lane + 32 * e;
        rows[e] = j < Sk ? lse[j] : 0.f;
        rows[2 + e] = j < Sk ? di[j] : 0.f;
      }
    }

    mbar_wait(sm.empty() + pp.st, pp.ph ^ 1);
    sm.seg_k(pp.st)[lane] = tile_sg[0];
    sm.seg_k(pp.st)[lane + 32] = tile_sg[1];
    sm.pos_k(pp.st)[lane] = tile_ps[0];
    sm.pos_k(pp.st)[lane + 32] = tile_ps[1];
    if (lane == 0) sm.flag()[pp.st] = full ? FULL : BOUNDARY;
    if constexpr (WALK_Q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sm.extra(pp.st)[lane + 32 * e] = rows[e];
    }
    if (rope_k != nullptr) {
      for (int idx = lane; idx < BK * (HALF / 8); idx += 32) {
        const int r = idx / (HALF / 8), d0 = idx % (HALF / 8) * 8;
        const int s = k0 + min(r, nk - 1);
        stage_pairs<D>(sm.k(pp.st), r, d0, r < nk,
                       k + (static_cast<size_t>(s) * Hkv + hk) * D, rope_k[s],
                       inv_freq);
      }
      fence_proxy_async();
    }
    uint64_t* bar = sm.full() + pp.st;
    if (lane == 0) {
      const int loads = rope_k != nullptr ? BOXES : 2 * BOXES;
      mbar_arrive_tx(bar, loads * BOX_BYTES);
      const uint32_t dk = smem_u32(sm.k(pp.st)), dv = smem_u32(sm.v(pp.st));
#pragma unroll
      for (int x = 0; x < BOXES; ++x) {
        if (rope_k == nullptr)
          tma_load(dk + x * BOX_BYTES, kmap, bar, hk * D + 64 * x, k0, b);
        tma_load(dv + x * BOX_BYTES, vmap, bar, hk * D + 64 * x, k0, b);
      }
    } else {
      mbar_arrive(bar);
    }
    pp.advance();
  }
}

// Producer warp, after its last sequence: a stage that tells the consumers
// to stop.
template <int D, int F, int X>
__device__ __forceinline__ void finish(const Smem<D, F, X>& sm, Pipe& pp) {
  mbar_wait(sm.empty() + pp.st, pp.ph ^ 1);
  if ((threadIdx.x & 31) == 0) sm.flag()[pp.st] = END;
  mbar_arrive(sm.full() + pp.st);
}

// A consumer thread's share of the online-softmax state: thread t of the
// warpgroup holds rows r0 = 16 (t / 32) + (t % 32) / 4 and r0 + 8 of the
// wgmma accumulator fragment; o[4j + 2h + e] is row r0 + 8h, column
// 8j + 2 (t % 4) + e (the same layout as the scores s of one K/V tile).
template <int D>
struct Acc {
  float o[Smem<D>::DP / 2];
  float m[2], l[2];
};

// The consumer warpgroup: for every tile the producer hands over,
// S = Q K^T (wgmma, fp32 accumulators), the scale and (BOUNDARY tiles) the
// mask on the fragment, the online softmax in registers (row max and sum
// over the four lanes that share a row), then O = O corr + bf16(P) V with P
// as the A operand straight from registers.
template <int D>
__device__ __forceinline__ void consume(const Smem<D>& sm, Acc<D>& acc,
                                        float scale, int causal) {
  constexpr int DP = Smem<D>::DP;
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2), cq = 2 * (lane & 3);
  const int sgq[2] = {sm.seg_q()[r0], sm.seg_q()[r0 + 8]};
  const int pq[2] = {sm.pos_q()[r0], sm.pos_q()[r0 + 8]};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc.o[i] = 0.f;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    acc.m[hr] = NEG_INF;
    acc.l[hr] = 0.f;
  }
  const uint32_t q_addr = smem_u32(sm.q());
  Pipe pp;
  while (true) {
    mbar_wait(sm.full() + pp.st, pp.ph);
    const int kind = sm.flag()[pp.st];
    if (kind == END) break;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t k_addr = smem_u32(sm.k(pp.st));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
      wgmma_ss_n64(s, desc(q_addr + off, 16, 1024),
                   desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();

#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale;
    if (kind == BOUNDARY) {
      const int* sk = sm.seg_k(pp.st);
      const int* pk = sm.pos_k(pp.st);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + cq + e;
          const int sgk = sk[col], psk = pk[col];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const bool ok = sgq[hr] != 0 && sgq[hr] == sgk &&
                            (!causal || pq[hr] >= psk);
            if (!ok) s[4 * j + 2 * hr + e] = NEG_INF;
          }
        }
    }

    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(fmaxf(acc.m[hr], mx), NEG_INF / 2);
      corr[hr] = expf(acc.m[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ev = expf(s[4 * j + 2 * hr + e] - m_new);
          s[4 * j + 2 * hr + e] = ev;
          sum += ev;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      acc.l[hr] = acc.l[hr] * corr[hr] + sum;  // the fp32 e, unrounded
      acc.m[hr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc.o[i] *= corr[(i >> 1) & 1];

    // P in bf16 as wgmma's A fragment: keys 16 kk .. 16 kk + 15 of rows r0
    // and r0 + 8 are exactly the scores' registers 8 kk .. 8 kk + 7
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    const uint32_t v_addr = smem_u32(sm.v(pp.st));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 keys = two 8-row groups of 1024 B
      wgmma_pv<DP>(acc.o, pa[kk], desc(v_addr + kk * 2048, 8192, 1024));
    wgmma_commit();
    wgmma_wait0();
    mbar_arrive(sm.empty() + pp.st);
    pp.advance();
  }
}

// Normalize and write a consumer thread's rows: out (one batch row,
// (Sq,Hq,D)) bf16, lse (this batch row's and head's (Sq,)) fp32. A row that
// attended nothing gives out 0 and lse -1e30.
template <int D>
__device__ __forceinline__ void write_out(const Acc<D>& acc, bf16* out,
                                          float* lse, int q0, int Sq, int Hq,
                                          int h) {
  constexpr int DP = Smem<D>::DP;
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = q0 + r0 + 8 * hr;
    if (s >= Sq) continue;
    const float l = acc.l[hr];
    const float l_safe = l > 0.f ? l : 1.f;
    bf16* o = out + (static_cast<size_t>(s) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(o + col) =
            __floats2bfloat162_rn(acc.o[4 * j + 2 * hr] / l_safe,
                                  acc.o[4 * j + 2 * hr + 1] / l_safe);
    }
    if ((lane & 3) == 0) lse[s] = l > 0.f ? acc.m[hr] + logf(l_safe) : NEG_INF;
  }
}

// Host: the tensor map of one K or V operand, bf16 viewed as 3-D (cols,
// rows, batches) at base (row stride cols, batch stride batch_stride
// elements), read in boxes of 64 columns x 64 rows with the 128-byte
// swizzle that the wgmma descriptors name; a box past an edge reads zeros.
inline cudaError_t kv_map(CUtensorMap* map, const void* base, long long cols,
                          long long rows, long long batches,
                          long long batch_stride) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batches)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[3] = {64, BK, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace
