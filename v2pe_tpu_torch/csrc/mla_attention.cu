// Kernel #12: paged latent attention (MLA, DeepSeek-V3's attention in its
// absorbed form) for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no latent attention. Added for
// the DeepSeek-V3 decoder (models/deepseek_v3.py, wrapper
// ops/mla_attention.py), whose cache is a latent pool, one tensor
// (L, NP, ps, 576) in bf16 (the pool's head axis is 1): each slot holds a
// token's 512 latents c (after kv_a_layernorm) and its 64 rotary key dims,
// rotated at its V2PE position. Every query head attends the same slots:
// the wrapper absorbs W_UK into the query (q = [q_nope W_UK | q_pe], 576
// wide) and W_UV into the output (out = softmax(q k^T * scale) c, 512 wide,
// which the wrapper multiplies by W_UV). So a head's score reads all 576
// dims of a slot and its output the first 512: V is the latent itself.
//
// One kernel, two forms (template NTOK, the query tokens of a block):
// - decode (NTOK 1, the engine's decode step, one token a row): grid
//   (splits, head groups, rows). A row's slots are cut into `splits` runs
//   of `span` slots (span from the page table's width, never the lengths,
//   which live on the device); a split writes its unnormalised sum, m and l
//   to an fp32 workspace, and the last block of a (row, head group), told
//   by an acquire-release counter that it resets, merges the splits in
//   split order and writes out. The step's own latent (`fresh`) is slot
//   `length`: every block reads it from `fresh`, and the block whose split
//   covers the slot stores it into the pool (head group 0), so the launch
//   stores the step's latent and attends it (fresh_in_pages, as #4 rides in
//   #5).
// - chunk (NTOK 4, chunked prefill): grid (ceil(T / 4), head groups, rows);
//   the chunk's latents are in the pool already (the wrapper scatters them)
//   and chunk token t attends slots < length + t + 1: the row's cached
//   pages and the chunk itself, causal, in one walk.
//
// A block holds NTOK tokens x 16 heads of queries in shared memory and walks
// the row's slots in tiles of 32 (two stages, 16-byte cp.async copies; each
// slot's page looked up once a tile; slots of a dead entry (-1) or past the
// block's end zero-filled and masked). Two warps a token: both compute the
// token's 16 x 32 scores on tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 sums; the 16 heads are the 16 rows of the tile) and keep the same
// online softmax; each accumulates one half (256) of the 512 output dims,
// so a warp holds 128 fp32 sums. The scores are computed twice, which costs
// 576 / 1088 more operations and no traffic: the output's 512 dims do not
// fit one warp's registers.
//
// Bounds: decode moves each slot's 1,152 bytes once a step for 16 heads'
// 2 x 16 x 1088 operations (30 per byte, under the card's ridge of 295):
// device memory bounds it. A 2048-token chunk over 32k slots does ~2.3
// TFLOP on the tensor cores against 38 MB of slots: operations bound it.
// The running max is clamped so that a row that attends nothing ends with
// l = 0 and out 0. Fixed orders: the same bits on every run.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using tc::bf16;

constexpr int DK = 576;          // a slot: latent 512 + rotary 64
constexpr int DV = 512;          // the output: the latent
constexpr int HG = 16;           // heads a group: the mma's 16 rows
constexpr int KT = 32;           // slots a tile
constexpr int LD = DK + 8;       // a shared row, padded: ldmatrix rows fall
                                 // on distinct banks (1,168 B = 73 x 16)
constexpr float NEG_INF = -1e30f;

struct MlaParams {
  const bf16* q;          // (B, T, H, DK)
  const bf16* fresh;      // decode: (B, DK), the step's latent; else null
  bf16* pool;             // (L, NP, ps, DK)
  const int* page_table;  // (B, MP)
  const int* lengths;     // (B,) slots before this step's tokens
  bf16* out;              // (B, T, H, DV)
  float* ws;              // decode, splits > 1: (B, H/16, splits, 16, 2 + DV)
  int* counters;          // decode, splits > 1: (B, H/16), zero
  int B, T, H, NP, ps, MP, layer, splits, span;
  float scale_log2;       // softmax scale x log2(e)
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The global address of slot s of row b in layer `layer`, or null for a
// dead entry or a slot past MP * ps.
__device__ __forceinline__ const bf16* slot_ptr(const MlaParams& p, int b,
                                                int s) {
  const int j = s / p.ps;
  if (j >= p.MP) return nullptr;
  const int page = p.page_table[static_cast<size_t>(b) * p.MP + j];
  if (page < 0 || page >= p.NP) return nullptr;
  return p.pool +
         ((static_cast<size_t>(p.layer) * p.NP + page) * p.ps + s % p.ps) *
             DK;
}

template <int NTOK>
__global__ void __launch_bounds__(64 * NTOK, 1)
    mla_attention_kernel(MlaParams p) {
  constexpr int THREADS = 64 * NTOK;
  constexpr int CHUNKS = DK / 8;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);       // [NTOK * 16][LD]
  bf16* sk = sq + NTOK * HG * LD;                 // [2][KT][LD]
  const bf16** rows =
      reinterpret_cast<const bf16**>(sk + 2 * KT * LD);  // [2][KT]
  int* live = reinterpret_cast<int*>(rows + 2 * KT);       // [2][KT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, hg = blockIdx.y;
  const bool decode = p.fresh != nullptr;
  const int t0 = decode ? 0 : blockIdx.x * NTOK;
  const int split = decode ? blockIdx.x : 0;
  const int length = p.lengths[b];
  const int cap = p.MP * p.ps;

  // the block's slots: [k0, k1)
  int k0 = 0, k1;
  if (decode) {
    k0 = split * p.span;
    k1 = min(min(k0 + p.span, length + 1), cap);
  } else {
    k1 = min(length + min(t0 + NTOK, p.T), cap);
  }

  // the queries: NTOK tokens x the group's 16 heads
  for (int i = tid; i < NTOK * HG * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int t = t0 + r / HG, h = hg * HG + r % HG;
    const bool ok = t < p.T;
    const bf16* src =
        p.q + ((static_cast<size_t>(b) * p.T + (ok ? t : 0)) * p.H + h) * DK +
        c * 8;
    tc::cp_async16(tc::smem_u32(sq + r * LD + c * 8), src, ok ? 16 : 0);
  }

  // A tile's copy: the first KT threads look up one slot's page each
  // (every slot's source once), then every thread issues 16-byte copies.
  // All threads call it (a barrier inside).
  auto load_tile = [&](int stage, int kb) {
    if (tid < KT) {
      const int slot = kb + tid;
      const bf16* src = nullptr;
      if (slot < k1) {
        src = slot_ptr(p, b, slot);
        if (decode && slot == length && src != nullptr)
          src = p.fresh + b * DK;
      }
      rows[stage * KT + tid] = src;
      live[stage * KT + tid] = src != nullptr;
    }
    __syncthreads();
    bf16* dst = sk + stage * KT * LD;
    for (int i = tid; i < KT * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = i % CHUNKS;
      const bf16* src = rows[stage * KT + r];
      tc::cp_async16(tc::smem_u32(dst + r * LD + c * 8),
                     src != nullptr ? src + c * 8 : p.pool, src ? 16 : 0);
    }
  };

  // the step's latent into its page (decode: the split that covers it)
  if (decode && hg == 0 && length >= k0 && length < k0 + p.span &&
      length < cap) {
    const bf16* dst = slot_ptr(p, b, length);
    if (dst != nullptr) {
      bf16* d = const_cast<bf16*>(dst);
      const bf16* f = p.fresh + b * DK;
      for (int c = tid; c < CHUNKS; c += THREADS)
        *reinterpret_cast<uint4*>(d + c * 8) =
            *reinterpret_cast<const uint4*>(f + c * 8);
    }
  }

  const int tt = warp >> 1, half = warp & 1;
  const int t = t0 + tt;
  // this warp's token sees slots < limit
  const int limit = decode ? length + 1 : length + t + 1;
  const int g = lane >> 2, qd = lane & 3;

  float o[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int tiles = k1 > k0 ? (k1 - k0 + KT - 1) / KT : 0;
  if (tiles > 0) load_tile(0, k0);
  tc::cp_async_commit();
  const uint32_t q_base =
      tc::smem_u32(sq + (tt * HG + (lane & 15)) * LD + (lane >> 4) * 8);

  for (int it = 0; it < tiles; ++it) {
    const int stage = it & 1, kb = k0 + it * KT;
    if (it + 1 < tiles) load_tile(stage ^ 1, kb + KT);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();

    const bf16* kt = sk + stage * KT * LD;
    // scores: 16 heads x 32 slots, four n-tiles of 8 slots
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const int mi = lane >> 3, ri = lane & 7;
#pragma unroll 4
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_base + kk * 32);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        const int key = 16 * j + 8 * (mi >> 1) + ri;
        ldsm_x4(r, tc::smem_u32(kt + key * LD + kk * 16 + (mi & 1) * 8));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        tc::mma_16816(s[2 * j], a, b0);
        tc::mma_16816(s[2 * j + 1], a, b1);
      }
    }
    // mask, then the online softmax of rows g and g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * qd + (e & 1);
        const int slot = kb + col;
        const bool ok = slot < limit && live[stage * KT + col];
        s[n][e] = ok ? s[n][e] * p.scale_log2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      mx[rr] = fmaxf(mx[rr], NEG_INF * 0.5f);  // masked scores -> exactly 0
      corr[rr] = exp2f(m[rr] - mx[rr]);
      m[rr] = mx[rr];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 1);
      rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 2);
      l[rr] = l[rr] * corr[rr] + rs[rr];
    }
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // o += p v over this warp's 256 dims: two k-steps of 16 slots
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[4];
      a[0] = tc::pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      a[1] = tc::pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      a[2] = tc::pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      a[3] = tc::pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const int key = 16 * ks + 8 * (mi & 1) + ri;
#pragma unroll
      for (int n = 0; n < 32; n += 2) {
        uint32_t r[4];
        const int d = half * 256 + 8 * n + 8 * (mi >> 1);
        ldsm_x4_t(r, tc::smem_u32(kt + key * LD + d));
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        tc::mma_16816(o[n], a, b0);
        tc::mma_16816(o[n + 1], a, b1);
      }
    }
    __syncthreads();  // the stage is free for the copy after next
  }
  tc::cp_async_wait<0>();

  const int h0 = hg * HG;
  if (!decode || p.splits == 1) {
    if (t >= p.T) return;
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                          l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int d = half * 256 + 8 * n + 2 * qd;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        bf16* dst = p.out +
                    ((static_cast<size_t>(b) * p.T + t) * p.H + h0 + g +
                     8 * rr) * DV + d;
        *reinterpret_cast<uint32_t*>(dst) =
            tc::pack_bf16(o[n][2 * rr] * inv[rr], o[n][2 * rr + 1] * inv[rr]);
      }
    }
    return;
  }

  // decode over splits: publish this split, the last block merges them
  const size_t row_span = 2 + DV;
  const int cell = b * (p.H / HG) + hg;
  float* ws = p.ws + static_cast<size_t>(cell) * p.splits * HG * row_span;
  float* mine = ws + static_cast<size_t>(split) * HG * row_span;
#pragma unroll
  for (int n = 0; n < 32; ++n) {
    const int d = half * 256 + 8 * n + 2 * qd;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float* row = mine + (g + 8 * rr) * row_span;
      row[2 + d] = o[n][2 * rr];
      row[3 + d] = o[n][2 * rr + 1];
    }
  }
  if (half == 0 && qd == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mine[(g + 8 * rr) * row_span] = m[rr];
      mine[(g + 8 * rr) * row_span + 1] = l[rr];
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(p.counters + cell)
                 : "memory");
    last = before == p.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int idx = tid; idx < HG * DV; idx += THREADS) {
    const int r = idx / DV, d = idx % DV;
    const float* src = ws + r * row_span;
    const size_t stride = HG * row_span;
    float mx = NEG_INF;
    for (int sp = 0; sp < p.splits; ++sp)
      mx = fmaxf(mx, __ldcg(src + sp * stride));
    float a = 0.f, ls = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float lsp = __ldcg(src + sp * stride + 1);
      if (lsp > 0.f) {  // an empty split adds nothing
        const float w = exp2f(__ldcg(src + sp * stride) - mx);
        a = fmaf(__ldcg(src + sp * stride + 2 + d), w, a);
        ls = fmaf(lsp, w, ls);
      }
    }
    p.out[(static_cast<size_t>(b) * p.H + h0 + r) * DV + d] =
        __float2bfloat16(ls > 0.f ? a / ls : 0.f);
  }
  __syncthreads();
  if (tid == 0) p.counters[cell] = 0;  // ready for the next launch
}

template <int NTOK>
cudaError_t launch(const MlaParams& p, dim3 grid, cudaStream_t stream) {
  const int smem = (NTOK * HG + 2 * KT) * LD * 2 + 2 * KT * (8 + 4);
  cudaError_t err = cudaFuncSetAttribute(
      mla_attention_kernel<NTOK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  mla_attention_kernel<NTOK><<<grid, 64 * NTOK, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (B, T, H, 576), pool (L, NP, ps, 576), out (B, T, H, 512), all bf16;
// page_table (B, MP), lengths (B,) int32. `fresh` (B, 576) selects the
// decode form (T == 1); null the chunk form. ws / counters: decode with
// splits > 1 (the wrapper keeps them; counters zero).
extern "C" int v2pe_mla_attention(const void* q, const void* fresh,
                                  void* pool, const int* page_table,
                                  const int* lengths, void* out, float* ws,
                                  int* counters, int B, int T, int H, int NP,
                                  int ps, int MP, int layer, int splits,
                                  int span, float scale, void* stream) {
  if (H % HG != 0 || B < 1 || T < 1 || ps < 1 || MP < 1 || splits < 1 ||
      (fresh != nullptr && T != 1) ||
      (fresh != nullptr && splits > 1 &&
       (ws == nullptr || counters == nullptr)) ||
      (fresh != nullptr && span % KT != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  MlaParams p;
  p.q = static_cast<const bf16*>(q);
  p.fresh = static_cast<const bf16*>(fresh);
  p.pool = static_cast<bf16*>(pool);
  p.page_table = page_table;
  p.lengths = lengths;
  p.out = static_cast<bf16*>(out);
  p.ws = ws;
  p.counters = counters;
  p.B = B;
  p.T = T;
  p.H = H;
  p.NP = NP;
  p.ps = ps;
  p.MP = MP;
  p.layer = layer;
  p.splits = fresh != nullptr ? splits : 1;
  p.span = fresh != nullptr ? span : MP * ps;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fresh != nullptr)
    return static_cast<int>(launch<1>(p, dim3(p.splits, H / HG, B), s));
  return static_cast<int>(launch<4>(p, dim3((T + 3) / 4, H / HG, B), s));
}
