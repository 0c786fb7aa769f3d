// Flash-attention backward for NVIDIA Hopper (sm_90a), fp32 or bf16 inputs.
//
// Replaces the two Pallas TPU kernels of v2pe_tpu/ops/flash_pallas_bwd.py
// (wrapper flash_attention_bwd_pallas): _dkv_kernel, by flash_bwd_dkv_kernel
// below, and _dq_kernel, by flash_bwd_dq_kernel. Same contract as the
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
// Design. The TPU kernels walk a sequential grid axis and carry their
// accumulators in VMEM scratch. Here:
// - dkv: one thread block owns one (batch row, kv head, 64-key tile) and
//   loops itself over the G query heads of the group and every 64-row query
//   tile; dk and dv accumulate in registers (4 key rows x D/16 columns per
//   thread, each) and are written once, with no atomics.
// - dq: one thread block owns one (batch row, q head, 64-query tile) and
//   loops over the key tiles, dq in registers.
// Tiles are staged in shared memory as fp32; the 64x64 products (q k^T,
// do v^T) and the accumulations are fp32 FMAs from shared memory. A tile
// pair is skipped, without loading q/do or k/v, when the min/max of its
// segment ids and positions show that no query can attend any key (this
// also skips the causal upper triangle for any positions, not only arange).
// A pair whose queries and keys all share one nonzero segment, and where
// (causal) every query comes at or after every key, is "full" and skips the
// element mask. The mask SELECTS p (never multiplies it): a row that attends
// nothing has lse = -1e30, where exp(s - lse) overflows to inf, and 0 * inf
// would put NaN into ds. A full pair has no such row (padding is segment 0,
// and partial tiles at the sequence end are never full).
//
// What bounds it. Like the forward, plain fp32 FMAs fed from shared memory:
// the CUDA cores and shared-memory bandwidth, far below the tensor cores'
// bf16 rate, with one 256-thread block per SM at D = 128 (~165 KB of shared
// memory). Right and simple first: wgmma with TMA-fed tiles is the work of
// a later change.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads: thread (ty, tx) owns rows
                              // ty + 16r and columns tx + 16c of each tile
constexpr int LDP = BK + 1;   // row stride of the 64x64 p / ds tiles

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

using LaunchFn = cudaError_t (*)(const Params&, cudaStream_t);

// The launcher for (kernel, dtype, D), or nullptr for a head dim without one.
LaunchFn pick(bool dkv, int is_bf16, int D) {
  LaunchFn fn = nullptr;
  if (D == 64 && dkv && is_bf16) fn = launch_dkv<__nv_bfloat16, 64>;
  if (D == 64 && dkv && !is_bf16) fn = launch_dkv<float, 64>;
  if (D == 64 && !dkv && is_bf16) fn = launch_dq<__nv_bfloat16, 64>;
  if (D == 64 && !dkv && !is_bf16) fn = launch_dq<float, 64>;
  if (D == 128 && dkv && is_bf16) fn = launch_dkv<__nv_bfloat16, 128>;
  if (D == 128 && dkv && !is_bf16) fn = launch_dkv<float, 128>;
  if (D == 128 && !dkv && is_bf16) fn = launch_dq<__nv_bfloat16, 128>;
  if (D == 128 && !dkv && !is_bf16) fn = launch_dq<float, 128>;
  return fn;
}

int run(bool dkv, const Params& p, int D, int is_bf16, void* stream) {
  const LaunchFn fn = pick(dkv, is_bf16, D);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(p, static_cast<cudaStream_t>(stream)));
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
