// The tile machinery of the forward flash-attention kernels for NVIDIA
// Hopper (sm_90a), shared by flash_fwd.cu (one K/V sequence per query tile)
// and ring_fused_fwd.cu (the K/V chunks of every rank of a ring, one after
// another, per query tile). A kernel stages its query tile with load_q,
// calls sweep_kv once per K/V sequence it attends (the online-softmax state
// m, l and the output accumulator carry over from one sweep to the next),
// and ends with write_out.
//
// One thread block owns one 64-row query tile of one head. K/V tiles of 64
// keys are staged in shared memory as fp32, the 64x64 scores and the
// online-softmax update run in fp32, and the output accumulator stays in
// registers (4 rows x D/16 columns per thread). The max is clamped at
// -1e30/2, so masked scores (-1e30) underflow exp to exactly 0 and a fully
// masked row ends with l = 0. A K/V tile is skipped without loading when the
// min/max of the tile's segment ids and positions show that no query of the
// block can attend any of its keys (this also skips the causal upper
// triangle of a packed prefill, whose positions need not be arange, and the
// dead half of a zigzag ring's hops).
//
// What bounds it. The products are plain fp32 FMAs fed from shared memory,
// two loads per FMA-pair of a 4x4 register tile, so the kernels are bound by
// shared-memory bandwidth and the CUDA cores, far below the tensor cores'
// bf16 rate. They are written to be right and simple first: moving QK^T and
// PV to wgmma with TMA-fed K/V tiles is the work of a later change.
//
// Rotary. cos/sin come from sincosf of the fp32 angle id * inv_freq[i] with
// inv_freq passed in by the wrapper (the same table the plain twin uses).
// Not built with --use_fast_math: angles reach the context length in
// radians, where __sinf/__cosf lose accuracy.

#pragma once

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 x 16 threads; thread (ty, tx) owns rows
                              // ty + 16r and columns tx + 16c of each tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* x,
                                          int row0, int S, int H, int h,
                                          const float* rope,
                                          const float* inv_freq, float mul) {
  constexpr int HALF = D / 2;
  for (int idx = threadIdx.x; idx < 64 * HALF; idx += THREADS) {
    const int r = idx / HALF, d = idx % HALF, s = row0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (s < S) {
      const T* src = x + (static_cast<size_t>(s) * H + h) * D;
      x1 = to_float(src[d]);
      x2 = to_float(src[d + HALF]);
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
template <typename T, int D>
__device__ __forceinline__ QSummary load_q(const Smem<D>& sm, const T* q,
                                           const int* seg_q, const int* pos_q,
                                           const float* rope_q,
                                           const float* inv_freq, int q0,
                                           int Sq, int Hq, int h,
                                           float scale) {
  const int tid = threadIdx.x;
  load_tile<T, D>(sm.q, Smem<D>::LDQ, q, q0, Sq, Hq, h, rope_q, inv_freq,
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
template <typename T, int D>
__device__ __forceinline__ void sweep_kv(const Smem<D>& sm, const QSummary& qs,
                                         float (&acc)[4][D / 16], const T* k,
                                         const T* v, const int* seg_k,
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

    load_tile<T, D>(sK, LDK, k, k0, Sk, Hkv, hk, rope_k, inv_freq, 1.f);
    load_tile<T, D>(sV, D, v, k0, Sk, Hkv, hk, nullptr, nullptr, 1.f);
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

// Normalize and write the tile: out (one batch row, (Sq,Hq,D)) in the input
// dtype, lse (this batch row's and head's (Sq,)) fp32. A row that attended
// nothing gives out 0 and lse -1e30.
template <typename T, int D>
__device__ __forceinline__ void write_out(const Smem<D>& sm,
                                          const float (&acc)[4][D / 16],
                                          T* out, float* lse, int q0, int Sq,
                                          int Hq, int h) {
  constexpr int NC = D / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r, s = q0 + row;
    if (s >= Sq) continue;
    const float l = sm.l[row];
    const float l_safe = l > 0.f ? l : 1.f;
    T* o = out + (static_cast<size_t>(s) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + tx + 16 * c, acc[r][c] / l_safe);
    if (tx == 0) lse[s] = l > 0.f ? sm.m[row] + logf(l_safe) : NEG_INF;
  }
}

}  // namespace
