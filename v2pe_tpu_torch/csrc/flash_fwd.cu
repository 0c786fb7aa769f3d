// Forward flash attention for NVIDIA Hopper (sm_90a), fp32 or bf16 inputs.
//
// Replaces the Pallas TPU kernel v2pe_tpu/ops/flash_pallas.py:_kernel
// (wrapper flash_attention_fwd_pallas). Same contract: q (B,Sq,Hq,D),
// k/v (B,Sk,Hkv,D), GQA through kv head h / (Hq/Hkv); a query attends a key
// iff both carry the same nonzero segment id and, if causal, pos_q >= pos_k;
// optional V2PE rotary of q (and k) from float32 ids inside the kernel;
// out in the input dtype, lse (B,Hq,Sq) fp32; a row with nothing to attend
// gives out 0 and lse -1e30.
//
// Design. The TPU kernel walks the kv axis sequentially per grid step and
// carries (acc, m, l) in VMEM scratch. Here one thread block owns one
// (batch row, q head, 64-row q tile) and loops over 64-row K/V tiles itself:
// the tiles are staged in shared memory as fp32, the 64x64 scores and the
// online-softmax update run in fp32, and the output accumulator stays in
// registers (4 rows x D/16 columns per thread). The max is clamped at
// -1e30/2, so masked scores (-1e30) underflow exp to exactly 0 and a fully
// masked row ends with l = 0. A K/V tile is skipped without loading when the
// min/max of the tile's segment ids and positions show that no query of the
// block can attend any of its keys (this also skips the causal upper
// triangle of a packed prefill, whose positions need not be arange).
//
// What bounds it. The products are plain fp32 FMAs fed from shared memory,
// two loads per FMA-pair of a 4x4 register tile, so the kernel is bound by
// shared-memory bandwidth and the CUDA cores, far below the tensor cores'
// bf16 rate. It is written to be right and simple first: moving QK^T and
// PV to wgmma with TMA-fed K/V tiles is the work of a later change.
//
// Rotary. cos/sin come from sincosf of the fp32 angle id * inv_freq[i] with
// inv_freq passed in by the wrapper (the same table the plain twin uses).
// Not built with --use_fast_math: angles reach the context length in
// radians, where __sinf/__cosf lose accuracy.

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg_q;
  const int* seg_k;
  const int* pos_q;
  const int* pos_k;
  const float* rope_q;    // nullptr: q is not rotated
  const float* rope_k;    // nullptr: k is not rotated
  const float* inv_freq;  // (D/2,) when either rope is given
  void* out;
  float* lse;
  int B, Sq, Sk, Hq, Hkv;
  int causal;
  float scale;
};

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

// Stage rows [row0, row0 + 64) of head h of x (B,S,H,D) into dst (fp32, row
// stride ld), rotated by the V2PE rotary at rope[b, s] when rope is given,
// times mul. Rows past S are zero.
template <typename T, int D>
__device__ void load_tile(float* dst, int ld, const T* x, int b, int row0,
                          int S, int H, int h, const float* rope,
                          const float* inv_freq, float mul) {
  constexpr int HALF = D / 2;
  for (int idx = threadIdx.x; idx < 64 * HALF; idx += THREADS) {
    const int r = idx / HALF, d = idx % HALF, s = row0 + r;
    float x1 = 0.f, x2 = 0.f;
    if (s < S) {
      const T* src = x + ((static_cast<size_t>(b) * S + s) * H + h) * D;
      x1 = to_float(src[d]);
      x2 = to_float(src[d + HALF]);
      if (rope != nullptr) {
        // x * cos + rotate_half(x) * sin, with rotate_half = [-x2, x1]
        float sn, cs;
        sincosf(rope[static_cast<size_t>(b) * S + s] * inv_freq[d], &sn,
                &cs);
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDS = BK + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // BQ x LDQ, pre-scaled (and rotated) q
  float* sK = sQ + BQ * LDQ;    // BK x LDK
  float* sV = sK + BK * LDK;    // BK x D
  float* sS = sV + BK * D;      // BQ x LDS, scores, then probabilities
  float* sM = sS + BQ * LDS;    // running max per row
  float* sL = sM + BQ;          // running sum per row
  float* sCorr = sL + BQ;       // this tile's rescale factor per row
  int* sSegQ = reinterpret_cast<int*>(sCorr + BQ);
  int* sPosQ = sSegQ + BQ;
  int* sSegK = sPosQ + BQ;
  int* sPosK = sSegK + BK;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_tile<T, D>(sQ, LDQ, static_cast<const T*>(p.q), b, q0, p.Sq, p.Hq, h,
                  p.rope_q, p.inv_freq, p.scale);
  if (tid < BQ) {
    const int s = q0 + tid;
    const bool ok = s < p.Sq;
    sSegQ[tid] = ok ? p.seg_q[static_cast<size_t>(b) * p.Sq + s] : 0;
    sPosQ[tid] = ok ? p.pos_q[static_cast<size_t>(b) * p.Sq + s] : -1;
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }
  __syncthreads();

  // Summaries of the q tile's valid rows (each thread computes the same).
  const int nq = min(BQ, p.Sq - q0);
  int sq_min = INT_MAX, sq_max = INT_MIN, pq_max = INT_MIN;
  for (int r = 0; r < nq; ++r) {
    sq_min = min(sq_min, sSegQ[r]);
    sq_max = max(sq_max, sSegQ[r]);
    pq_max = max(pq_max, sPosQ[r]);
  }

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < p.Sk; k0 += BK) {
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();  // the previous tile's readers are done with smem
    if (tid < BK) {
      const bool ok = tid < nk;
      const size_t i = static_cast<size_t>(b) * p.Sk + k0 + tid;
      sSegK[tid] = ok ? p.seg_k[i] : 0;
      sPosK[tid] = ok ? p.pos_k[i] : (1 << 30);
    }
    __syncthreads();

    int sk_min = INT_MAX, sk_max = INT_MIN, pk_min = INT_MAX;
    for (int j = 0; j < nk; ++j) {
      sk_min = min(sk_min, sSegK[j]);
      sk_max = max(sk_max, sSegK[j]);
      pk_min = min(pk_min, sPosK[j]);
    }
    const bool dead = sq_max < sk_min || sk_max < sq_min ||
                      (sk_min == 0 && sk_max == 0) ||
                      (sq_min == 0 && sq_max == 0) ||
                      (p.causal && pq_max < pk_min);
    if (dead) continue;  // uniform across the block

    load_tile<T, D>(sK, LDK, static_cast<const T*>(p.k), b, k0, p.Sk, p.Hkv,
                    hk, p.rope_k, p.inv_freq, 1.f);
    load_tile<T, D>(sV, D, static_cast<const T*>(p.v), b, k0, p.Sk, p.Hkv,
                    hk, nullptr, nullptr, 1.f);
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
      const int sg = sSegQ[row], pq = sPosQ[row];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const bool ok = sg != 0 && sg == sSegK[col] &&
                        (!p.causal || pq >= sPosK[col]);
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
      const float m_prev = sM[row];
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
        sCorr[row] = corr;
        sL[row] = sL[row] * corr + sum;
        sM[row] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float corr = sCorr[ty + 16 * r];
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

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r, s = q0 + row;
    if (s >= p.Sq) continue;
    const float l = sL[row];
    const float l_safe = l > 0.f ? l : 1.f;
    T* o = out + ((static_cast<size_t>(b) * p.Sq + s) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + tx + 16 * c, acc[r][c] / l_safe);
    if (tx == 0)
      p.lse[(static_cast<size_t>(b) * p.Hq + h) * p.Sq + s] =
          l > 0.f ? sM[row] + logf(l_safe) : NEG_INF;
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted.
extern "C" int v2pe_flash_fwd(const void* q, const void* k, const void* v,
                              const int* seg_q, const int* seg_k,
                              const int* pos_q, const int* pos_k,
                              const float* rope_q, const float* rope_k,
                              const float* inv_freq, void* out, float* lse,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D,
                              int is_bf16, int causal, float scale,
                              void* stream) {
  const Params p{q,      k,      v,        seg_q, seg_k, pos_q, pos_k,
                 rope_q, rope_k, inv_freq, out,   lse,   B,     Sq,
                 Sk,     Hq,     Hkv,      causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = is_bf16 ? launch<__nv_bfloat16, 64>(p, st) : launch<float, 64>(p, st);
  } else if (D == 128) {
    err = is_bf16 ? launch<__nv_bfloat16, 128>(p, st)
                  : launch<float, 128>(p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
