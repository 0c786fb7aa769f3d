// Paged-KV attention for NVIDIA Hopper (sm_90a): the fresh-token store, the
// decode attention and the chunked-prefill attention over a page pool.
//
// Replaces the Pallas TPU kernels of v2pe_tpu/ops/paged_attention.py:
//   paged_store_kernel   <- _store_kernel   (wrapper store_fresh_token)
//   paged_decode_kernel  <- _attn_kernel    (wrapper paged_decode_attention)
//   paged_prefill_kernel <- _prefill_kernel (wrapper paged_prefill_attention)
// Pool layout as in JAX: values (L, Hkv, NP, ps, D) in the queries' dtype or
// int8, quantized pools with scales (L, Hkv, NP, 1, ps) fp32; page_table and
// slot_base (B, MP) int32 (-1 = unallocated / dead entry), lengths (B,)
// int32. Each kernel takes the whole pool and a layer index, as the Pallas
// index maps do, so nothing copies the pool per layer.
//
// int4 pools (JAX: jnp.int4 pages) are bytes here, (L, Hkv, NP, ps, D/2):
// byte d of a slot holds dim d in its low nibble and dim d + D/2 in its high
// nibble (the convention of quantized_matmul.cu), so one token's vector of
// one head is D/2 whole bytes and a store never shares a byte with another
// token. It is a mode of the same three kernels (pool type int4x2): the
// store quantizes with qmax 7 and packs, decode and prefill unpack while
// they stage a chunk; the scales enter exactly as in the int8 mode.
//
// Design. The TPU kernels walk a row's page table over a sequential grid
// axis and carry (acc, m, l) in VMEM scratch. Here one thread block owns the
// whole walk and loops over the pages itself, 64 page slots at a time. Page
// slots are contiguous rows of D values, so each 64-slot chunk is one
// contiguous block, read with 16-byte loads and staged as fp32 in shared
// memory. Scores and the online softmax run in fp32; the running max is
// clamped at -1e30/2 so masked scores underflow to exactly 0 and a row that
// attends nothing ends with l = 0 (out 0, lse -1e30). int8 pools: the k
// scale multiplies the score before the softmax; the v scale multiplies the
// softmax weight after l has been summed, so l stays unscaled, as in
// paged_attention.py:229-233.
//
// - store: one block per (row, kv head), one thread per element of the
//   head's D values; int8 rounds x / (amax/127) half to even (rintf) and
//   clips to +-127, the scale 1 where amax is 0 (jnp.round semantics).
// - decode: one block per (row, kv head) holds the T*G query rows that
//   share the head (q row r is fresh token r / G), so every page byte is
//   read once per head. fresh_in_pages: token t sees slots <= length + t;
//   otherwise slots < length, then the fresh k/v are folded in as one more
//   chunk, causal among themselves.
// - prefill: one block per (row, q head, 64-row q tile) as in flash_fwd.cu;
//   every chunk row sees every cached slot < length.
//
// What bounds them. Decode reads each cached byte once per step and does
// 2*T*G FLOPs per byte-pair: it is bound by device memory, and with one
// block per (row, kv head) by how few blocks are in flight at small batch
// (8 at batch 1); a split of the pages over blocks is a later change.
// Prefill is the flash kernel's fp32 FMA loop from shared memory, bound by
// the CUDA cores; wgmma/TMA products are a later change. The store is a
// few hundred bytes per row.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 64;  // page slots per chunk

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(int8_t* p, float x) {
  *p = static_cast<int8_t>(x);
}

// An int4 pool's element: two codes of one token in a byte.
struct int4x2 {
  int8_t b;
};
// the low nibble sign-extended, and the high one by an arithmetic shift
__device__ __forceinline__ int nibble_lo(int b) {
  return static_cast<int>(static_cast<unsigned>(b) << 28) >> 28;
}
__device__ __forceinline__ int nibble_hi(int b) { return b >> 4; }

// Pool elements per slot of D values, and the largest code.
template <typename KV, int D>
struct PoolRow {
  static constexpr int W = D;
  static constexpr float QMAX = 127.f;
};
template <int D>
struct PoolRow<int4x2, D> {
  static constexpr int W = D / 2;
  static constexpr float QMAX = 7.f;
};

// Stage `cap` rows of D values into dst (fp32, row stride ld), times mul:
// rows [0, nrows) from src (row stride `stride` elements, 16-byte aligned),
// the rest zero.
template <typename T, int D>
__device__ void load_rows(float* dst, int ld, const T* src, size_t stride,
                          int nrows, int cap, float mul) {
  if constexpr (std::is_same<T, int4x2>::value) {
    // 16 bytes hold dims [16 cv, 16 cv + 16) and the same plus D/2
    constexpr int NV = D / 32;
    for (int idx = threadIdx.x; idx < cap * NV; idx += blockDim.x) {
      const int r = idx / NV, cv = idx % NV;
      float* o = dst + r * ld + cv * 16;
      if (r < nrows) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + r * stride + cv * 16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          o[i] = static_cast<float>(nibble_lo(e[i])) * mul;
          o[D / 2 + i] = static_cast<float>(nibble_hi(e[i])) * mul;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) o[i] = o[D / 2 + i] = 0.f;
      }
    }
  } else {
    constexpr int V = 16 / sizeof(T), NV = D / V;
    for (int idx = threadIdx.x; idx < cap * NV; idx += blockDim.x) {
      const int r = idx / NV, cv = idx % NV;
      float* o = dst + r * ld + cv * V;
      if (r < nrows) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(src + r * stride + cv * V);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = to_float(e[i]) * mul;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = 0.f;
      }
    }
  }
}

// ------------------------------------------------------------------ store

struct StoreParams {
  const void* k_new;  // (B, 1, Hkv, D)
  const void* v_new;
  void* k_pages;
  void* v_pages;
  float* k_scales;  // nullptr unless the pool is quantized
  float* v_scales;
  const int* page_table;
  const int* lengths;
  int Hkv, NP, ps, MP, layer;
};

// max over the block of two values (blockDim.x a multiple of 32, <= 1024)
__device__ float2 block_max2(float a, float b, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  const int warp = threadIdx.x / 32, nw = blockDim.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp] = a;
    red[32 + warp] = b;
  }
  __syncthreads();
  float2 r = make_float2(red[0], red[32]);
  for (int w = 1; w < nw; ++w) {
    r.x = fmaxf(r.x, red[w]);
    r.y = fmaxf(r.y, red[32 + w]);
  }
  return r;
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(D) paged_store_kernel(const StoreParams p) {
  constexpr int W = PoolRow<KV, D>::W;
  constexpr float QMAX = PoolRow<KV, D>::QMAX;
  __shared__ float red[64];
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int len = p.lengths[b];
  const int page = p.page_table[static_cast<size_t>(b) * p.MP +
                                min(len / p.ps, p.MP - 1)];
  if (page < 0) return;  // unallocated: no write (uniform over the block)
  const size_t slot =
      ((static_cast<size_t>(p.layer) * p.Hkv + h) * p.NP + page) * p.ps +
      len % p.ps;
  const size_t src = (static_cast<size_t>(b) * p.Hkv + h) * D + d;
  float xk = to_float(static_cast<const T*>(p.k_new)[src]);
  float xv = to_float(static_cast<const T*>(p.v_new)[src]);
  if (p.k_scales != nullptr) {
    const float2 amax = block_max2(fabsf(xk), fabsf(xv), red);
    const float sk = amax.x > 0.f ? amax.x / QMAX : 1.f;
    const float sv = amax.y > 0.f ? amax.y / QMAX : 1.f;
    xk = fminf(fmaxf(rintf(xk / sk), -QMAX), QMAX);
    xv = fminf(fmaxf(rintf(xv / sv), -QMAX), QMAX);
    if (d == 0) {
      p.k_scales[slot] = sk;
      p.v_scales[slot] = sv;
    }
  }
  if constexpr (std::is_same<KV, int4x2>::value) {
    // thread d < D/2 packs its code with that of thread d + D/2
    __shared__ int code[2][D];
    code[0][d] = static_cast<int>(xk);
    code[1][d] = static_cast<int>(xv);
    __syncthreads();
    if (d < W) {
      int8_t* kp = static_cast<int8_t*>(p.k_pages) + slot * W + d;
      int8_t* vp = static_cast<int8_t*>(p.v_pages) + slot * W + d;
      *kp = static_cast<int8_t>((code[0][d] & 0xF) | (code[0][d + W] << 4));
      *vp = static_cast<int8_t>((code[1][d] & 0xF) | (code[1][d + W] << 4));
    }
  } else {
    store(static_cast<KV*>(p.k_pages) + slot * W + d, xk);
    store(static_cast<KV*>(p.v_pages) + slot * W + d, xv);
  }
}

// ----------------------------------------------------------------- decode

struct DecodeParams {
  const void* q;      // (B, T, Hq, D)
  const void* k_new;  // (B, T, Hkv, D) when the fresh tokens are folded
  const void* v_new;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* page_table;
  const int* slot_base;
  const int* lengths;
  void* out;   // (B, T, Hq, D)
  float* lse;  // (B, Hq, T) or nullptr
  int T, Hq, Hkv, NP, ps, MP, layer;
  int fresh_in_pages, fold;
  float scale;
};

constexpr int DEC_THREADS = 256;

template <int D>
size_t decode_smem_bytes(int R) {
  // sQ, sAcc (R x D), sK (BK x D+1), sV (BK x D), sS (R x BK+1),
  // m/l/corr (R each), k/v scales of a chunk (BK each)
  return sizeof(float) * (2 * R * D + BK * (2 * D + 1) + R * (BK + 1) +
                          3 * R + 2 * BK);
}

// Fold one staged chunk of nk keys into the R rows' online softmax. Key c
// is visible to row r iff c < nk and base + c <= lim0 + (r / G) * tstep.
template <int D>
__device__ void decode_chunk(const float* sQ, const float* sK, const float* sV,
                             float* sS, float* sAcc, float* sM, float* sL,
                             float* sCorr, const float* sKs, const float* sVs,
                             int R, int G, int nk, int base, int lim0,
                             int tstep) {
  constexpr int LDK = D + 1, LDS = BK + 1;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < R * BK; idx += DEC_THREADS) {
    const int r = idx / BK, c = idx % BK;
    float s = NEG_INF;
    if (c < nk && base + c <= lim0 + (r / G) * tstep) {
      const float* qr = sQ + r * D;
      const float* kr = sK + c * LDK;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      s = sKs != nullptr ? acc * sKs[c] : acc;
    }
    sS[r * LDS + c] = s;
  }
  __syncthreads();
  // one warp per row, two keys per lane
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < R; r += DEC_THREADS / 32) {
    float* srow = sS + r * LDS;
    float mx = fmaxf(srow[lane], srow[lane + 32]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = sM[r];
    const float m_new = fmaxf(fmaxf(m_prev, mx), NEG_INF / 2);
    float e0 = expf(srow[lane] - m_new), e1 = expf(srow[lane + 32] - m_new);
    float sum = e0 + e1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (sVs != nullptr) {  // v's scale enters after l took the sum
      if (lane < nk) e0 *= sVs[lane];
      if (lane + 32 < nk) e1 *= sVs[lane + 32];
    }
    srow[lane] = e0;
    srow[lane + 32] = e1;
    if (lane == 0) {
      const float corr = expf(m_prev - m_new);
      sCorr[r] = corr;
      sL[r] = sL[r] * corr + sum;
      sM[r] = m_new;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += DEC_THREADS) {
    const int r = idx / D, d = idx % D;
    const float* pr = sS + r * LDS;
    float a = sAcc[idx] * sCorr[r];
    for (int c = 0; c < nk; ++c) a = fmaf(pr[c], sV[c * D + d], a);
    sAcc[idx] = a;
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(DEC_THREADS)
    paged_decode_kernel(const DecodeParams p) {
  constexpr int LDK = D + 1, W = PoolRow<KV, D>::W;
  const int b = blockIdx.x, hk = blockIdx.y, tid = threadIdx.x;
  const int G = p.Hq / p.Hkv, R = p.T * G;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sAcc = sQ + R * D;
  float* sK = sAcc + R * D;
  float* sV = sK + BK * LDK;
  float* sS = sV + BK * D;
  float* sM = sS + R * (BK + 1);
  float* sL = sM + R;
  float* sCorr = sL + R;
  float* sKs = sCorr + R;
  float* sVs = sKs + BK;
  const bool quant = p.k_scales != nullptr;

  const T* q = static_cast<const T*>(p.q);
  for (int idx = tid; idx < R * D; idx += DEC_THREADS) {
    const int r = idx / D, d = idx % D, t = r / G, g = r % G;
    sQ[idx] = to_float(q[((static_cast<size_t>(b) * p.T + t) * p.Hq +
                          hk * G + g) * D + d]) * p.scale;
    sAcc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += DEC_THREADS) {
    sM[r] = NEG_INF;
    sL[r] = 0.f;
  }

  const int length = p.lengths[b];
  const int page_end = length + (p.fresh_in_pages ? p.T : 0);
  // fresh_in_pages: slot <= length + t; otherwise slot <= length - 1
  const int lim0 = p.fresh_in_pages ? length : length - 1;
  const int tstep = p.fresh_in_pages ? 1 : 0;
  const KV* kp = static_cast<const KV*>(p.k_pages);
  const KV* vp = static_cast<const KV*>(p.v_pages);
  const size_t head = (static_cast<size_t>(p.layer) * p.Hkv + hk) * p.NP;
  for (int j = 0; j < p.MP; ++j) {
    const int sb = p.slot_base[static_cast<size_t>(b) * p.MP + j];
    if (sb < 0 || sb >= page_end) continue;  // dead entry or past the end
    const int page = max(p.page_table[static_cast<size_t>(b) * p.MP + j], 0);
    const size_t row0 = (head + page) * p.ps;  // first slot of the page
    for (int c0 = 0; c0 < p.ps && sb + c0 < page_end; c0 += BK) {
      const int nk = min(BK, p.ps - c0);
      __syncthreads();  // the previous chunk's readers are done
      load_rows<KV, D>(sK, LDK, kp + (row0 + c0) * W, W, nk, nk, 1.f);
      load_rows<KV, D>(sV, D, vp + (row0 + c0) * W, W, nk, nk, 1.f);
      if (quant && tid < nk) {
        sKs[tid] = p.k_scales[row0 + c0 + tid];
        sVs[tid] = p.v_scales[row0 + c0 + tid];
      }
      __syncthreads();
      decode_chunk<D>(sQ, sK, sV, sS, sAcc, sM, sL, sCorr,
                      quant ? sKs : nullptr, quant ? sVs : nullptr, R, G, nk,
                      sb + c0, lim0, tstep);
    }
  }
  if (p.fold) {  // the separate fresh tokens, causal among themselves
    const size_t fresh = (static_cast<size_t>(b) * p.T * p.Hkv + hk) * D;
    __syncthreads();
    load_rows<T, D>(sK, LDK, static_cast<const T*>(p.k_new) + fresh,
                    static_cast<size_t>(p.Hkv) * D, p.T, p.T, 1.f);
    load_rows<T, D>(sV, D, static_cast<const T*>(p.v_new) + fresh,
                    static_cast<size_t>(p.Hkv) * D, p.T, p.T, 1.f);
    __syncthreads();
    decode_chunk<D>(sQ, sK, sV, sS, sAcc, sM, sL, sCorr, nullptr, nullptr, R,
                    G, p.T, 0, 0, 1);
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  for (int idx = tid; idx < R * D; idx += DEC_THREADS) {
    const int r = idx / D, d = idx % D, t = r / G, g = r % G;
    const float l = sL[r];
    store(out + ((static_cast<size_t>(b) * p.T + t) * p.Hq + hk * G + g) * D +
              d,
          sAcc[idx] / (l > 0.f ? l : 1.f));
  }
  if (p.lse != nullptr) {
    for (int r = tid; r < R; r += DEC_THREADS) {
      const int t = r / G, g = r % G;
      const float l = sL[r];
      p.lse[(static_cast<size_t>(b) * p.Hq + hk * G + g) * p.T + t] =
          l > 0.f ? sM[r] + logf(l) : NEG_INF;
    }
  }
}

// ---------------------------------------------------------------- prefill

struct PrefillParams {
  const void* q;  // (B, S, Hq, D)
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* page_table;
  const int* slot_base;
  const int* lengths;
  void* out;   // (B, S, Hq, D)
  float* lse;  // (B, Hq, S)
  int S, Hq, Hkv, NP, ps, MP, layer;
  float scale;
};

constexpr int BQ = 64;        // chunk rows per block
constexpr int PF_THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows
                                 // ty + 16r and columns tx + 16c of a tile

template <int D>
constexpr size_t prefill_smem_bytes() {
  // sQ, sK (rows padded by 1 float), sV, sS, per-row m/l/corr, the chunk's
  // k/v scales
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D +
                          BQ * (BK + 1) + 3 * BQ + 2 * BK);
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(PF_THREADS)
    paged_prefill_kernel(const PrefillParams p) {
  constexpr int LDQ = D + 1, LDK = D + 1, LDS = BK + 1, NC = D / 16;
  constexpr int W = PoolRow<KV, D>::W;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LDQ;
  float* sV = sK + BK * LDK;
  float* sS = sV + BK * D;
  float* sM = sS + BQ * LDS;
  float* sL = sM + BQ;
  float* sCorr = sL + BQ;
  float* sKs = sCorr + BQ;
  float* sVs = sKs + BK;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool quant = p.k_scales != nullptr;

  load_rows<T, D>(sQ, LDQ,
                  static_cast<const T*>(p.q) +
                      ((static_cast<size_t>(b) * p.S + q0) * p.Hq + h) * D,
                  static_cast<size_t>(p.Hq) * D, min(BQ, p.S - q0), BQ,
                  p.scale);
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  const int length = p.lengths[b];
  const KV* kp = static_cast<const KV*>(p.k_pages);
  const KV* vp = static_cast<const KV*>(p.v_pages);
  const size_t head = (static_cast<size_t>(p.layer) * p.Hkv + hk) * p.NP;
  for (int j = 0; j < p.MP; ++j) {
    const int sb = p.slot_base[static_cast<size_t>(b) * p.MP + j];
    if (sb < 0 || sb >= length) continue;
    const int page = max(p.page_table[static_cast<size_t>(b) * p.MP + j], 0);
    const size_t row0 = (head + page) * p.ps;
    for (int c0 = 0; c0 < p.ps && sb + c0 < length; c0 += BK) {
      // keys [0, nv) of the chunk are cached slots (< length)
      const int nv = min(min(BK, p.ps - c0), length - sb - c0);
      __syncthreads();  // the previous chunk's readers are done
      load_rows<KV, D>(sK, LDK, kp + (row0 + c0) * W, W, nv, BK, 1.f);
      load_rows<KV, D>(sV, D, vp + (row0 + c0) * W, W, nv, BK, 1.f);
      if (quant && tid < BK) {
        sKs[tid] = tid < nv ? p.k_scales[row0 + c0 + tid] : 0.f;
        sVs[tid] = tid < nv ? p.v_scales[row0 + c0 + tid] : 0.f;
      }
      __syncthreads();

      // scores: a 4x4 register tile per thread, masked into sS
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
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          const float sc = quant ? s[r][c] * sKs[col] : s[r][c];
          sS[(ty + 16 * r) * LDS + col] = col < nv ? sc : NEG_INF;
        }
      }
      __syncthreads();

      // online softmax: four neighbouring threads share a row, 16 keys each
      {
        const int row = tid >> 2, part = tid & 3;
        float* srow = sS + row * LDS + part * 16;
        float mx = NEG_INF;
#pragma unroll
        for (int j2 = 0; j2 < 16; ++j2) mx = fmaxf(mx, srow[j2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_prev = sM[row];
        const float m_new = fmaxf(fmaxf(m_prev, mx), NEG_INF / 2);
        float sum = 0.f;
#pragma unroll
        for (int j2 = 0; j2 < 16; ++j2) {
          const float e = expf(srow[j2] - m_new);
          sum += e;
          // v's scale enters after l took the sum
          srow[j2] = quant ? e * sVs[part * 16 + j2] : e;
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
      for (int j2 = 0; j2 < nv; ++j2) {
        float pr[4], vv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r] = sS[(ty + 16 * r) * LDS + j2];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = sV[j2 * D + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty + 16 * r, s = q0 + row;
    if (s >= p.S) continue;
    const float l = sL[row];
    const float l_safe = l > 0.f ? l : 1.f;
    T* o = out + ((static_cast<size_t>(b) * p.S + s) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + tx + 16 * c, acc[r][c] / l_safe);
    if (tx == 0)
      p.lse[(static_cast<size_t>(b) * p.Hq + h) * p.S + s] =
          l > 0.f ? sM[row] + logf(l_safe) : NEG_INF;
  }
}

// --------------------------------------------------------------- launches

template <typename T, typename KV, int D>
cudaError_t launch_store(const StoreParams& p, int B, cudaStream_t st) {
  paged_store_kernel<T, KV, D><<<dim3(B, p.Hkv), D, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_decode(const DecodeParams& p, int B, cudaStream_t st) {
  const size_t smem = decode_smem_bytes<D>(p.T * (p.Hq / p.Hkv));
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, KV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, KV, D><<<dim3(B, p.Hkv), DEC_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_prefill(const PrefillParams& p, int B, cudaStream_t st) {
  constexpr size_t smem = prefill_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<T, KV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, B);
  paged_prefill_kernel<T, KV, D><<<grid, PF_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// Dispatch over (input dtype, pool type, head dim) to a launcher. kv_bits:
// 0 for a pool in the queries' dtype, 8 for int8 codes, 4 for packed int4.
template <template <typename, typename, int> class L, typename T, typename P>
cudaError_t dispatch_pool(const P& p, int B, int D, int kv_bits,
                          cudaStream_t st) {
  if (kv_bits == 8)
    return D == 64 ? L<T, int8_t, 64>::run(p, B, st)
                   : L<T, int8_t, 128>::run(p, B, st);
  if (kv_bits == 4)
    return D == 64 ? L<T, int4x2, 64>::run(p, B, st)
                   : L<T, int4x2, 128>::run(p, B, st);
  return D == 64 ? L<T, T, 64>::run(p, B, st) : L<T, T, 128>::run(p, B, st);
}

template <template <typename, typename, int> class L, typename P>
cudaError_t dispatch(const P& p, int B, int D, int is_bf16, int kv_bits,
                     cudaStream_t st) {
  if ((D != 64 && D != 128) || (kv_bits != 0 && kv_bits != 8 && kv_bits != 4))
    return cudaErrorInvalidValue;
  return is_bf16 ? dispatch_pool<L, __nv_bfloat16>(p, B, D, kv_bits, st)
                 : dispatch_pool<L, float>(p, B, D, kv_bits, st);
}

template <typename T, typename KV, int D>
struct Store {
  static cudaError_t run(const StoreParams& p, int B, cudaStream_t st) {
    return launch_store<T, KV, D>(p, B, st);
  }
};
template <typename T, typename KV, int D>
struct Decode {
  static cudaError_t run(const DecodeParams& p, int B, cudaStream_t st) {
    return launch_decode<T, KV, D>(p, B, st);
  }
};
template <typename T, typename KV, int D>
struct Prefill {
  static cudaError_t run(const PrefillParams& p, int B, cudaStream_t st) {
    return launch_prefill<T, KV, D>(p, B, st);
  }
};

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns a cudaError_t: 0
// when the launch was accepted.

extern "C" int v2pe_paged_store(const void* k_new, const void* v_new,
                                void* k_pages, void* v_pages, float* k_scales,
                                float* v_scales, const int* page_table,
                                const int* lengths, int B, int Hkv, int NP,
                                int ps, int D, int MP, int layer, int is_bf16,
                                int kv_bits, void* stream) {
  const StoreParams p{k_new,      v_new,   k_pages, v_pages, k_scales,
                      v_scales,   page_table, lengths, Hkv,  NP,
                      ps,         MP,      layer};
  return static_cast<int>(dispatch<Store>(p, B, D, is_bf16, kv_bits,
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int v2pe_paged_decode(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const float* k_scales, const float* v_scales,
    const int* page_table, const int* slot_base, const int* lengths,
    void* out, float* lse, int B, int T, int Hq, int Hkv, int NP, int ps,
    int D, int MP, int layer, int is_bf16, int kv_bits, int fresh_in_pages,
    int fold, float scale, void* stream) {
  const DecodeParams p{q,          k_new,      v_new,   k_pages, v_pages,
                       k_scales,   v_scales,   page_table, slot_base,
                       lengths,    out,        lse,     T,       Hq,
                       Hkv,        NP,         ps,      MP,      layer,
                       fresh_in_pages, fold,   scale};
  return static_cast<int>(dispatch<Decode>(p, B, D, is_bf16, kv_bits,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int v2pe_paged_prefill(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* page_table,
    const int* slot_base, const int* lengths, void* out, float* lse, int B,
    int S, int Hq, int Hkv, int NP, int ps, int D, int MP, int layer,
    int is_bf16, int kv_bits, float scale, void* stream) {
  const PrefillParams p{q,        k_pages,  v_pages, k_scales, v_scales,
                        page_table, slot_base, lengths, out,   lse,
                        S,        Hq,       Hkv,     NP,       ps,
                        MP,       layer,    scale};
  return static_cast<int>(dispatch<Prefill>(p, B, D, is_bf16, kv_bits,
                                            static_cast<cudaStream_t>(stream)));
}
