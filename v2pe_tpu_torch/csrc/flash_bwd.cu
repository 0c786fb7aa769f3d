// Flash-attention backward for NVIDIA Hopper (sm_90a), fp32 or bf16 inputs.
//
// Replaces the two Pallas TPU kernels of v2pe_tpu/ops/flash_pallas_bwd.py
// (wrapper flash_attention_bwd_pallas): _dkv_kernel, by flash_bwd_dkv_kernel
// (fp32) and flash_bwd_dkv_kernel_tc (bf16) below, and _dq_kernel, by
// flash_bwd_dq_kernel and flash_bwd_dq_kernel_tc. Same contract as the
// forward (csrc/flash_fwd.cu): q/do (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), q head h
// reads kv head h / (Hq/Hkv); a query attends a key iff both carry the same
// nonzero segment id and, if causal, pos_q >= pos_k. Probabilities are
// recomputed from the forward's logsumexp: p = exp(q.k^T * scale - lse)
// under the mask, and with di = rowsum(do * out) (fp32, from the wrapper):
//   dv = sum_q p^T do,  ds = p * (do v^T - di),  dk = sum_q ds^T (q scale),
//   dq = ds k scale.
// dk/dv sum over the G = Hq/Hkv query heads of their kv head. Outputs are in
// the input dtype. The rotary is applied by the wrapper (in torch) before
// these kernels run, so they see rotated q and k.
//
// Both dtypes: dkv is one thread block per (batch row, kv head, 64-key
// tile) that walks the G query heads of the group and every 64-row query
// tile, dk and dv in registers, written once with no atomics (the Pallas
// kernel's scratch accumulator); dq is one block per (batch row, q head,
// 64-query tile) that walks the key tiles, dq in registers. A tile pair is
// skipped before q/do or k/v is loaded when the min/max of its segment ids
// and positions show that no query can attend any key (this also skips the
// causal upper triangle for any positions, not only arange). A pair whose
// queries and keys all share one nonzero segment, and where (causal) every
// query comes at or after every key, is FULL and skips the element mask.
// The mask SELECTS p (never multiplies it): a row that attends nothing has
// lse = -1e30, where exp(s - lse) overflows to inf, and 0 * inf would put
// NaN into ds. A FULL pair has no such row (padding is segment 0, and a
// tile cut by the sequence end is never FULL on the walked side).
//
// bf16: the tensor-core kernels, on the machinery of flash_tile.cuh (the
// forward's): one consumer warpgroup and one producer warp, 160 threads. The
// block's own tile pair is staged once by all threads (dq: Q and dO; dkv: K
// and V), swizzled for wgmma; the producer walks the other side's 64-row
// tiles with flash_tile.cuh's one walk (tc::produce; for dkv turned round,
// over the query tiles of the G heads, each with its 64 rows of lse and di),
// skips the dead ones, and feeds the live ones by TMA (tensor maps of k/v,
// or of q/do, viewed as (H*D, S, B)) through the 2-stage full/empty
// mbarrier ring, each marked FULL or BOUNDARY. Per live tile the consumers
// run, all by wgmma with fp32 accumulators:
//   dq:  S = Q K^T and dP = dO V^T (both operands from shared memory,
//        K-major, issued together), p and ds on the fragments, then
//        dQ += bf16(ds) K with ds as the A operand from registers and K
//        read through the descriptor's transpose bit;
//   dkv: S^T = K Q^T and dP^T = V dO^T, p^T and ds^T on the fragments, then
//        dV += bf16(p^T) dO and dK += bf16(ds^T) Q the same way.
// The rounding points: bf16 operands, p rounded to bf16 for dV only, ds for
// dK and dQ only; s, dP, p for ds, ds and every accumulator stay fp32; the
// scale multiplies the fp32 scores and the final dK and dQ. The exponential
// is the special function unit's ex2.approx (relative error ~2^-22). dq
// launches the last (heaviest causal) query tiles first, dkv the first key
// tiles (which every later query attends). Registers (ptxas): dkv 220 at D
// 128 (dK and dV are 128 fp32 a thread beside the two score fragments), so
// one block an SM with up to 255; dkv 156 at D 64 and dq 154 / 122 run two
// or three blocks an SM, where one's elementwise step overlaps the others'
// products. Nothing spills. Head dim 96 runs the D 128 bodies' shapes: its
// tiles store 128 columns (flash_tile.cuh: no product sums over the pad)
// and dQ, dK, dV accumulate at n128 (the pad's columns never stored), so
// dkv takes 224 registers (one block an SM) and dq 158 (two; CUDA 12.8).
//
// What bounds it: the tensor cores' bf16 rate in principle (dkv runs four
// 64 x 64 x D products per live tile pair, dq three, far above the card's
// ~300 operations per byte of q, k, v and do), and it runs well below it. A
// warpgroup waits for its own products before the elementwise step and for
// the next products after it, so the tensor cores overlap only across the
// blocks of an SM. Timed variants (chip_ablate.py): the loads are hidden
// (without TMA at all: no faster); the accurate expf cost a third of the
// time, hence ex2.approx; issuing dP's product before S's exp within a
// warpgroup was slower (more registers, no gain); a third stage slows dq at
// D 128 (one block an SM fewer); two dkv blocks an SM at D 128 spill and
// take twice as long. What would come next: a second consumer warpgroup in
// dkv at D 128 (128 keys a block, each warpgroup 64 of them, sharing every
// Q/dO tile), and a di = rowsum(do * out) prologue fused into dq.
//
// fp32: the CUDA-core kernels, the exact counterpart of the Pallas kernels'
// fp32 arithmetic: tiles staged in shared memory as fp32, the 64x64
// products (q k^T, do v^T) and the accumulations in fp32 FMAs from shared
// memory, bound by the CUDA cores and shared-memory bandwidth (one
// 256-thread block per SM at D = 128, ~165 KB of shared memory).

#include "flash_tile.cuh"

namespace {

// BQ = BK = 64 and THREADS = 256 (16 x 16 threads: thread (ty, tx) owns rows
// ty + 16r and columns tx + 16c of each tile) come from flash_tile.cuh.
constexpr int LDP = BK + 1;   // row stride of the 64x64 p / ds tiles

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // (B, Hq, Sq)
  const float* di;   // (B, Hq, Sq)
  const int* seg_q;
  const int* seg_k;
  const int* pos_q;
  const int* pos_k;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, Hq, Hkv;
  int causal;
  float scale;
};

// Stage rows [row0, row0 + 64) of head h of x (B,S,H,D) into dst (fp32, row
// stride ld), times mul. Rows past S are zero.
template <typename T, int D>
__device__ void load_rows(float* dst, int ld, const T* x, int b, int row0,
                          int S, int H, int h, float mul) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, s = row0 + r;
    float val = 0.f;
    if (s < S)
      val = to_float(x[((static_cast<size_t>(b) * S + s) * H + h) * D + d]);
    dst[r * ld + d] = val * mul;
  }
}

// Segment ids and positions of rows [row0, row0 + 64) into seg/pos; rows
// past S get segment 0 (attend nothing) and position pad.
__device__ void load_ids(int* seg, int* pos, const int* seg_g,
                         const int* pos_g, int b, int row0, int S, int pad) {
  if (threadIdx.x < 64) {
    const int s = row0 + threadIdx.x;
    const bool ok = s < S;
    const size_t i = static_cast<size_t>(b) * S + s;
    seg[threadIdx.x] = ok ? seg_g[i] : 0;
    pos[threadIdx.x] = ok ? pos_g[i] : pad;
  }
}

struct Summary {
  int seg_min, seg_max, pos_min, pos_max;
  bool complete;  // all 64 rows lie inside the sequence
};

// Min/max over the n valid rows of a tile (every thread computes the same).
__device__ Summary summarize(const int* seg, const int* pos, int n) {
  Summary s{INT_MAX, INT_MIN, INT_MAX, INT_MIN, n == 64};
  for (int i = 0; i < n; ++i) {
    s.seg_min = min(s.seg_min, seg[i]);
    s.seg_max = max(s.seg_max, seg[i]);
    s.pos_min = min(s.pos_min, pos[i]);
    s.pos_max = max(s.pos_max, pos[i]);
  }
  return s;
}

enum Live { kDead = 0, kPartial = 1, kFull = 2 };

// The tile pair's class, as ops/attention.py:_liveness classifies blocks.
__device__ Live liveness(const Summary& q, const Summary& k, int causal) {
  const bool dead = q.seg_max < k.seg_min || k.seg_max < q.seg_min ||
                    k.seg_max == 0 || q.seg_max == 0 ||
                    (causal && q.pos_max < k.pos_min);
  if (dead) return kDead;
  bool full = q.complete && k.complete && q.seg_min == q.seg_max &&
              k.seg_min == k.seg_max && q.seg_min == k.seg_min &&
              q.seg_min != 0;
  if (causal) full = full && q.pos_min >= k.pos_max;
  return full ? kFull : kPartial;
}

// s[r][c] = sum_d A[ty + 16r][d] * B[tx + 16c][d] over a 64x64 pair of
// tiles (rows of A: queries, rows of B: keys).
template <int D>
__device__ __forceinline__ void tile_products(const float* A, const float* B,
                                              int ty, int tx,
                                              float (&s)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = B[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
  }
}

// p and ds of a live tile pair into sP (may be null) and sDS, 64x64 each
// (row = query, column = key), from the staged q (scaled), do, k, v.
template <int D>
__device__ void probs_and_ds(const float* sQ, const float* sDO,
                             const float* sK, const float* sV,
                             const float* sLse, const float* sDi,
                             const int* sSegQ, const int* sPosQ,
                             const int* sSegK, const int* sPosK, Live live,
                             int causal, int ty, int tx, float* sP,
                             float* sDS) {
  float s[4][4], dp[4][4];
  tile_products<D>(sQ, sK, ty, tx, s);
  tile_products<D>(sDO, sV, ty, tx, dp);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r;
    const int sg = sSegQ[row], pq = sPosQ[row];
    const float lse = sLse[row], di = sDi[row];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tx + 16 * c;
      const bool ok = live == kFull ||
                      (sg != 0 && sg == sSegK[col] &&
                       (!causal || pq >= sPosK[col]));
      const float pr = ok ? expf(s[r][c] - lse) : 0.f;
      if (sP != nullptr) sP[row * LDP + col] = pr;
      sDS[row * LDP + col] = pr * (dp[r][c] - di);
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // sK, sV, sQ, sDO (rows padded by 1 against bank conflicts), sP, sDS,
  // lse, di; then the ids of the q and k tiles
  return (4 * 64 * (D + 1) + 2 * 64 * LDP + 2 * BQ) * sizeof(float) +
         (2 * BQ + 2 * BK) * sizeof(int);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (4 * 64 * (D + 1) + 64 * LDP + 2 * BQ) * sizeof(float) +
         (2 * BQ + 2 * BK) * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const Params p) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // BK x LD
  float* sV = sK + BK * LD;     // BK x LD
  float* sQ = sV + BK * LD;     // BQ x LD, q * scale
  float* sDO = sQ + BQ * LD;    // BQ x LD
  float* sP = sDO + BQ * LD;    // BQ x LDP
  float* sDS = sP + BQ * LDP;   // BQ x LDP
  float* sLse = sDS + BQ * LDP;
  float* sDi = sLse + BQ;
  int* sSegQ = reinterpret_cast<int*>(sDi + BQ);
  int* sPosQ = sSegQ + BQ;
  int* sSegK = sPosQ + BQ;
  int* sPosK = sSegK + BK;

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_rows<T, D>(sK, LD, static_cast<const T*>(p.k), b, k0, p.Sk, p.Hkv, hk,
                  1.f);
  load_rows<T, D>(sV, LD, static_cast<const T*>(p.v), b, k0, p.Sk, p.Hkv, hk,
                  1.f);
  load_ids(sSegK, sPosK, p.seg_k, p.pos_k, b, k0, p.Sk, 1 << 30);
  __syncthreads();
  const Summary ks = summarize(sSegK, sPosK, min(BK, p.Sk - k0));

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t vec = (static_cast<size_t>(b) * p.Hq + h) * p.Sq;
    for (int q0 = 0; q0 < p.Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done with smem
      load_ids(sSegQ, sPosQ, p.seg_q, p.pos_q, b, q0, p.Sq, -1);
      if (tid < BQ) {
        const bool ok = q0 + tid < p.Sq;
        sLse[tid] = ok ? p.lse[vec + q0 + tid] : 0.f;
        sDi[tid] = ok ? p.di[vec + q0 + tid] : 0.f;
      }
      __syncthreads();
      const Live live =
          liveness(summarize(sSegQ, sPosQ, min(BQ, p.Sq - q0)), ks, p.causal);
      if (live == kDead) continue;  // uniform across the block

      load_rows<T, D>(sQ, LD, static_cast<const T*>(p.q), b, q0, p.Sq, p.Hq,
                      h, p.scale);
      load_rows<T, D>(sDO, LD, static_cast<const T*>(p.dout), b, q0, p.Sq,
                      p.Hq, h, 1.f);
      __syncthreads();
      probs_and_ds<D>(sQ, sDO, sK, sV, sLse, sDi, sSegQ, sPosQ, sSegK, sPosK,
                      live, p.causal, ty, tx, sP, sDS);
      __syncthreads();

      // dv[key][d] += p[q][key] do[q][d]; dk[key][d] += ds[q][key] qs[q][d]
#pragma unroll 4
      for (int j = 0; j < BQ; ++j) {
        float pk[4], dsk[4], od[NC], qd[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pk[r] = sP[j * LDP + ty + 16 * r];
          dsk[r] = sDS[j * LDP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          od[c] = sDO[j * LD + tx + 16 * c];
          qd[c] = sQ[j * LD + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dv[r][c] = fmaf(pk[r], od[c], dv[r][c]);
            dk[r][c] = fmaf(dsk[r], qd[c], dk[r][c]);
          }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = k0 + ty + 16 * r;
    if (s >= p.Sk) continue;
    const size_t o = ((static_cast<size_t>(b) * p.Sk + s) * p.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dk_out + o + tx + 16 * c, dk[r][c]);
      store(dv_out + o + tx + 16 * c, dv[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const Params p) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x LD, q * scale
  float* sDO = sQ + BQ * LD;    // BQ x LD
  float* sK = sDO + BQ * LD;    // BK x LD
  float* sV = sK + BK * LD;     // BK x LD
  float* sDS = sV + BK * LD;    // BQ x LDP
  float* sLse = sDS + BQ * LDP;
  float* sDi = sLse + BQ;
  int* sSegQ = reinterpret_cast<int*>(sDi + BQ);
  int* sPosQ = sSegQ + BQ;
  int* sSegK = sPosQ + BQ;
  int* sPosK = sSegK + BK;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t vec = (static_cast<size_t>(b) * p.Hq + h) * p.Sq;

  load_rows<T, D>(sQ, LD, static_cast<const T*>(p.q), b, q0, p.Sq, p.Hq, h,
                  p.scale);
  load_rows<T, D>(sDO, LD, static_cast<const T*>(p.dout), b, q0, p.Sq, p.Hq,
                  h, 1.f);
  load_ids(sSegQ, sPosQ, p.seg_q, p.pos_q, b, q0, p.Sq, -1);
  if (tid < BQ) {
    const bool ok = q0 + tid < p.Sq;
    sLse[tid] = ok ? p.lse[vec + q0 + tid] : 0.f;
    sDi[tid] = ok ? p.di[vec + q0 + tid] : 0.f;
  }
  __syncthreads();
  const Summary qs = summarize(sSegQ, sPosQ, min(BQ, p.Sq - q0));

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with smem
    load_ids(sSegK, sPosK, p.seg_k, p.pos_k, b, k0, p.Sk, 1 << 30);
    __syncthreads();
    const Live live =
        liveness(qs, summarize(sSegK, sPosK, min(BK, p.Sk - k0)), p.causal);
    if (live == kDead) continue;  // uniform across the block

    load_rows<T, D>(sK, LD, static_cast<const T*>(p.k), b, k0, p.Sk, p.Hkv,
                    hk, 1.f);
    load_rows<T, D>(sV, LD, static_cast<const T*>(p.v), b, k0, p.Sk, p.Hkv,
                    hk, 1.f);
    __syncthreads();
    probs_and_ds<D>(sQ, sDO, sK, sV, sLse, sDi, sSegQ, sPosQ, sSegK, sPosK,
                    live, p.causal, ty, tx, nullptr, sDS);
    __syncthreads();

    // dq[q][d] += ds[q][key] k[key][d]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float a[4], kd[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sDS[(ty + 16 * r) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) kd[c] = sK[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(a[r], kd[c], acc[r][c]);
    }
  }

  T* dq = static_cast<T*>(p.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = q0 + ty + 16 * r;
    if (s >= p.Sq) continue;
    T* o = dq + ((static_cast<size_t>(b) * p.Sq + s) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + tx + 16 * c, acc[r][c] * p.scale);
  }
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + BK - 1) / BK, p.Hkv, p.B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// bf16: the tensor-core kernels.
// ------------------------------------------------------------------------

using bf16 = tc::bf16;

// dq: Q and dO staged, K and V streamed. dkv: K and V staged, Q and dO
// streamed with the 64 rows' lse and di.
template <int D>
using DqSmem = tc::Smem<D, 2>;
template <int D>
using DkvSmem = tc::Smem<D, 2, 2 * BQ>;

struct TcParams {
  Params p;
  CUtensorMap amap, bmap;  // dq: k, v as (Hkv*D, Sk, B); dkv: q, do as
                           // (Hq*D, Sq, B)
};

// d = A B^T over D, 64 x 64: A and B 64-row tiles at a and b (swizzled,
// K-major, as staged), by m64n64k16 steps along D.
template <int D>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
    tc::wgmma_ss_n64(d, tc::desc(a + off, 16, 1024),
                     tc::desc(b + off, 16, 1024), kk > 0);
  }
}

// The fp32 accumulator of a 64 x D product whose N is the head: DP / 2 a
// thread (at D 96 its columns 96-127 are the pad's, never stored).
template <int D>
using Rows = float[tc::Smem<D>::DP / 2];

// d += A B, 64 x DP: A a 64 x 64 fragment in bf16 registers (to_a), B the
// 64-row tile at b whose rows are the product's depth (MN-major through the
// descriptor's transpose bit: no transposed copy). 16 rows = two 8-row
// groups of 1024 bytes.
template <int D>
__device__ __forceinline__ void accumulate(Rows<D>& d,
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    tc::wgmma_pv<tc::Smem<D>::DP>(d, a[kk],
                                  tc::desc(b + kk * 2048, 8192, 1024));
}

// A 64 x 64 fp32 fragment rounded to bf16 as wgmma's A operand: columns
// 16 kk .. 16 kk + 15 of rows r0 and r0 + 8 are registers 8 kk .. 8 kk + 7.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = tc::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// e^x by the special function unit's 2^x (ex2.approx, relative error about
// 2^-22, subnormal results flushed to 0). expf's exact range reduction made
// the exponentials a third of the kernels' time.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// On a consumer thread's share of a 64 x 64 fragment (rows r0 and r0 + 8 of
// the staged tile, columns 8j + 2 (t % 4) + e of the streamed one; the
// forward's layout): s becomes p = exp(s scale - lse) where the mask lets the
// pair through and 0 elsewhere (selected, never multiplied), dp becomes
// ds = p (dp - di). Rows are queries (dq: lse_r, di_r per row) or, KEY_ROWS,
// keys (dkv: lse and di per column from the stage, lse_c and di_c). The ids:
// the rows' own, and the columns' from the stage; read only on BOUNDARY
// tiles.
template <bool KEY_ROWS>
__device__ __forceinline__ void probs_ds(
    float (&s)[32], float (&dp)[32], bool full, const int (&seg_r)[2],
    const int (&pos_r)[2], const int* seg_c, const int* pos_c,
    const float (&lse_r)[2], const float (&di_r)[2], const float* lse_c,
    const float* di_c, int causal, float scale) {
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + cq + e;
      const float lse_col = KEY_ROWS ? lse_c[col] : 0.f;
      const float di_col = KEY_ROWS ? di_c[col] : 0.f;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = 4 * j + 2 * hr + e;
        const bool ok =
            full || (seg_r[hr] != 0 && seg_r[hr] == seg_c[col] &&
                     (!causal || (KEY_ROWS ? pos_c[col] >= pos_r[hr]
                                           : pos_r[hr] >= pos_c[col])));
        const float lse = KEY_ROWS ? lse_col : lse_r[hr];
        const float di = KEY_ROWS ? di_col : di_r[hr];
        const float pr = ok ? exp_sfu(s[i] * scale - lse) : 0.f;
        s[i] = pr;
        dp[i] = pr * (dp[i] - di);
      }
    }
}

// Write a consumer thread's rows of a 64 x D fp32 accumulator, times mul, in
// bf16: rows row0 + r0 and row0 + r0 + 8 (those below S) of head h of one
// batch row's (S,H,D).
template <int D>
__device__ __forceinline__ void write_rows(const Rows<D>& acc,
                                           float mul, bf16* out, int row0,
                                           int S, int H, int h) {
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2), cq = 2 * (lane & 3);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = row0 + r0 + 8 * hr;
    if (s >= S) continue;
    bf16* o = out + (static_cast<size_t>(s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hr] * mul,
                                acc[4 * j + 2 * hr + 1] * mul);
  }
}

// dq: grid (Hq, B, query tiles), the query tile counted down so that the
// heaviest causal tiles start first.
template <int D>
__global__ void __launch_bounds__(tc::THREADS, 2)
    flash_bwd_dq_kernel_tc(const __grid_constant__ TcParams tp) {
  const Params& p = tp.p;
  extern __shared__ uint8_t smem_raw[];
  const DqSmem<D> sm(smem_raw);
  const int h = blockIdx.x;
  const size_t b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const size_t qoff = b * p.Sq * p.Hq * D;

  tc::stage_rows<D>(sm.fixed(1), static_cast<const bf16*>(p.dout) + qoff,
                    nullptr, nullptr, q0, p.Sq, p.Hq, h);
  tc::setup<D>(sm, static_cast<const bf16*>(p.q) + qoff, p.seg_q + b * p.Sq,
               p.pos_q + b * p.Sq, nullptr, nullptr, q0, p.Sq, p.Hq, h);
  if (threadIdx.x >= tc::CONSUMERS) {
    const tc::QRange qr = tc::q_range<D>(sm, min(BQ, p.Sq - q0));
    tc::Pipe pp;
    tc::produce<D>(sm, pp, qr, &tp.amap, &tp.bmap, static_cast<int>(b),
                   nullptr, p.seg_k + b * p.Sk, p.pos_k + b * p.Sk, nullptr,
                   nullptr, p.Sk, p.Hkv, hk, p.causal);
    tc::finish<D>(sm, pp);
    return;
  }
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const size_t vec = (b * p.Hq + h) * p.Sq;
  int seg_r[2], pos_r[2];
  float lse_r[2], di_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = r0 + 8 * hr, s = q0 + r;
    seg_r[hr] = sm.seg_q()[r];
    pos_r[hr] = sm.pos_q()[r];
    lse_r[hr] = s < p.Sq ? p.lse[vec + s] : 0.f;
    di_r[hr] = s < p.Sq ? p.di[vec + s] : 0.f;
  }
  Rows<D> acc;
#pragma unroll
  for (int i = 0; i < tc::Smem<D>::DP / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = tc::smem_u32(sm.q());
  const uint32_t do_addr = tc::smem_u32(sm.fixed(1));
  tc::Pipe pp;
  while (true) {
    tc::mbar_wait(sm.full() + pp.st, pp.ph);
    const int kind = sm.flag()[pp.st];
    if (kind == tc::END) break;
    const uint32_t k_addr = tc::smem_u32(sm.k(pp.st));
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::wgmma_fence();
    scores<D>(s, q_addr, k_addr);
    scores<D>(dp, do_addr, tc::smem_u32(sm.v(pp.st)));
    tc::wgmma_commit();
    tc::wgmma_wait0();
    probs_ds<false>(s, dp, kind == tc::FULL, seg_r, pos_r, sm.seg_k(pp.st),
                    sm.pos_k(pp.st), lse_r, di_r, nullptr, nullptr, p.causal,
                    p.scale);
    uint32_t ds[4][4];
    to_a(ds, dp);
    tc::wgmma_fence();
    accumulate<D>(acc, ds, k_addr);
    tc::wgmma_commit();
    tc::wgmma_wait0();
    tc::mbar_arrive(sm.empty() + pp.st);
    pp.advance();
  }
  write_rows<D>(acc, p.scale, static_cast<bf16*>(p.dq) + qoff, q0, p.Sq,
                p.Hq, h);
}

// dkv: grid (Hkv, B, key tiles), the key tile counted up so that the first
// key tiles, which every later causal query attends, start first.
template <int D>
__global__ void __launch_bounds__(tc::THREADS, D == 64 ? 2 : 1)
    flash_bwd_dkv_kernel_tc(const __grid_constant__ TcParams tp) {
  const Params& p = tp.p;
  extern __shared__ uint8_t smem_raw[];
  const DkvSmem<D> sm(smem_raw);
  const int hk = blockIdx.x;
  const size_t b = blockIdx.y;
  const int k0 = blockIdx.z * BK;
  const int G = p.Hq / p.Hkv;
  const size_t koff = b * p.Sk * p.Hkv * D;

  tc::stage_rows<D>(sm.fixed(1), static_cast<const bf16*>(p.v) + koff,
                    nullptr, nullptr, k0, p.Sk, p.Hkv, hk);
  tc::setup<D>(sm, static_cast<const bf16*>(p.k) + koff, p.seg_k + b * p.Sk,
               p.pos_k + b * p.Sk, nullptr, nullptr, k0, p.Sk, p.Hkv, hk);
  if (threadIdx.x >= tc::CONSUMERS) {
    const tc::QRange kr = tc::q_range<D>(sm, min(BK, p.Sk - k0));
    tc::Pipe pp;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      const size_t vec = (b * p.Hq + h) * p.Sq;
      tc::produce<D, true>(sm, pp, kr, &tp.amap, &tp.bmap,
                           static_cast<int>(b), nullptr, p.seg_q + b * p.Sq,
                           p.pos_q + b * p.Sq, nullptr, nullptr, p.Sq, p.Hq,
                           h, p.causal, p.lse + vec, p.di + vec);
    }
    tc::finish<D>(sm, pp);
    return;
  }
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);
  const int seg_r[2] = {sm.seg_q()[r0], sm.seg_q()[r0 + 8]};
  const int pos_r[2] = {sm.pos_q()[r0], sm.pos_q()[r0 + 8]};
  const float none[2] = {0.f, 0.f};
  Rows<D> dk, dv;
#pragma unroll
  for (int i = 0; i < tc::Smem<D>::DP / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_addr = tc::smem_u32(sm.q());
  const uint32_t v_addr = tc::smem_u32(sm.fixed(1));
  tc::Pipe pp;
  while (true) {
    tc::mbar_wait(sm.full() + pp.st, pp.ph);
    const int kind = sm.flag()[pp.st];
    if (kind == tc::END) break;
    const uint32_t q_addr = tc::smem_u32(sm.k(pp.st));
    const uint32_t do_addr = tc::smem_u32(sm.v(pp.st));
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::wgmma_fence();
    scores<D>(s, k_addr, q_addr);
    scores<D>(dp, v_addr, do_addr);
    tc::wgmma_commit();
    tc::wgmma_wait0();
    const float* rows = sm.extra(pp.st);  // lse, then di, of the 64 queries
    probs_ds<true>(s, dp, kind == tc::FULL, seg_r, pos_r, sm.seg_k(pp.st),
                   sm.pos_k(pp.st), none, none, rows, rows + BQ, p.causal,
                   p.scale);
    uint32_t pa[4][4], da[4][4];
    to_a(pa, s);
    to_a(da, dp);
    tc::wgmma_fence();
    accumulate<D>(dv, pa, do_addr);
    accumulate<D>(dk, da, q_addr);
    tc::wgmma_commit();
    tc::wgmma_wait0();
    tc::mbar_arrive(sm.empty() + pp.st);
    pp.advance();
  }
  write_rows<D>(dk, p.scale, static_cast<bf16*>(p.dk) + koff, k0, p.Sk,
                p.Hkv, hk);
  write_rows<D>(dv, 1.f, static_cast<bf16*>(p.dv) + koff, k0, p.Sk, p.Hkv,
                hk);
}

// Host: the tensor maps of the streamed tiles, the shared-memory size and
// the grid.
template <int D>
cudaError_t launch_tc(bool dkv, const Params& p, cudaStream_t stream) {
  TcParams tp{p, {}, {}};
  const void* a = dkv ? p.q : p.k;
  const void* bb = dkv ? p.dout : p.v;
  const long long rows = dkv ? p.Sq : p.Sk;
  const long long cols = static_cast<long long>(dkv ? p.Hq : p.Hkv) * D;
  cudaError_t err = tc::kv_map(&tp.amap, a, cols, rows, p.B, rows * cols);
  if (err == cudaSuccess)
    err = tc::kv_map(&tp.bmap, bb, cols, rows, p.B, rows * cols);
  if (err != cudaSuccess) return err;
  if (dkv) {
    constexpr size_t smem = DkvSmem<D>::BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel_tc<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(p.Hkv, p.B, (p.Sk + BK - 1) / BK);
    flash_bwd_dkv_kernel_tc<D><<<grid, tc::THREADS, smem, stream>>>(tp);
  } else {
    constexpr size_t smem = DqSmem<D>::BYTES;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel_tc<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(p.Hq, p.B, (p.Sq + BQ - 1) / BQ);
    flash_bwd_dq_kernel_tc<D><<<grid, tc::THREADS, smem, stream>>>(tp);
  }
  return cudaGetLastError();
}

// bf16 inputs run the tensor-core kernels, fp32 inputs the CUDA-core ones.
int run(bool dkv, const Params& p, int D, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = is_bf16 ? launch_tc<64>(dkv, p, st)
                  : (dkv ? launch_dkv<float, 64>(p, st)
                         : launch_dq<float, 64>(p, st));
  } else if (D == 96) {
    err = is_bf16 ? launch_tc<96>(dkv, p, st)
                  : (dkv ? launch_dkv<float, 96>(p, st)
                         : launch_dq<float, 96>(p, st));
  } else if (D == 128) {
    err = is_bf16 ? launch_tc<128>(dkv, p, st)
                  : (dkv ? launch_dkv<float, 128>(p, st)
                         : launch_dq<float, 128>(p, st));
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns a cudaError_t: 0
// when the launch was accepted.
extern "C" int v2pe_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* di, const int* seg_q,
                                  const int* seg_k, const int* pos_q,
                                  const int* pos_k, void* dk, void* dv, int B,
                                  int Sq, int Sk, int Hq, int Hkv, int D,
                                  int is_bf16, int causal, float scale,
                                  void* stream) {
  const Params p{q,     k,     v,     dout,    lse,     di, seg_q,
                 seg_k, pos_q, pos_k, nullptr, dk,      dv, B,
                 Sq,    Sk,    Hq,    Hkv,     causal, scale};
  return run(true, p, D, is_bf16, stream);
}

extern "C" int v2pe_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* di, const int* seg_q,
                                 const int* seg_k, const int* pos_q,
                                 const int* pos_k, void* dq, int B, int Sq,
                                 int Sk, int Hq, int Hkv, int D, int is_bf16,
                                 int causal, float scale, void* stream) {
  const Params p{q,     k,     v,     dout, lse,     di,      seg_q,
                 seg_k, pos_q, pos_k, dq,   nullptr, nullptr, B,
                 Sq,    Sk,    Hq,    Hkv,  causal,  scale};
  return run(false, p, D, is_bf16, stream);
}
