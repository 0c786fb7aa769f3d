// Paged-KV attention for NVIDIA Hopper (sm_90a): the fresh-token store, the
// decode attention and the chunked-prefill attention over a page pool.
//
// Replaces the Pallas TPU kernels of v2pe_tpu/ops/paged_attention.py:
//   paged_store_kernel   <- _store_kernel   (wrapper store_fresh_token)
//   paged_decode_kernel  <- _attn_kernel    (wrapper paged_decode_attention)
//   paged_prefill_kernel <- _prefill_kernel (wrapper paged_prefill_attention;
//     paged_prefill_tc_kernel for bf16 queries)
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
// token. It is a mode of the same kernels (pool type int4x2): the store
// quantizes with qmax 7 and packs, decode and prefill unpack the codes; the
// scales enter exactly as in the int8 mode.
//
// Common to decode and prefill: the running max is clamped at -1e30/2 so
// masked scores underflow to exactly 0 and a row that attends nothing ends
// with l = 0 (out 0, lse -1e30). Quantized pools: the k scale multiplies the
// fp32 score before the softmax; the v scale multiplies the softmax weight
// after l has taken its sum, so l stays unscaled, as in
// paged_attention.py:229-233. Slots of a page past the row's end are read
// and masked; a pool holds finite values (it is allocated as zeros).
//
// - store (store_vec): one warp per fresh vector (a token's k or v of one
//   kv head); int8 rounds x / (amax/127) half to even (rintf) and clips to
//   +-127, the scale 1 where amax is 0 (jnp.round semantics). Two launches
//   run it: paged_store_kernel (store_fresh_token, a launch of its own) and
//   the decode kernel with `store` set, which writes its row's fresh tokens
//   itself, so a decode step launches no store. At T = 1 with the fresh
//   token in the pages the one block whose split covers the target slot
//   stores it before its copies read it; in the fold mode (T <= 16) the
//   last block of a (row, kv head) to finish reading stores the first
//   store_n tokens. A sequence shard's T = 1 store (fresh_pages, the Pallas
//   store's override) takes each row's page from fresh_pages, -1 where
//   another shard holds it: nothing is written for that row.
//
// - decode (T <= 16 fresh queries, R = T * G query rows per kv head; q row r
//   is fresh token r / G): a memory-bound split-K kernel, as FlashDecoding
//   does. The grid is (row, kv head, split x row block): the wrapper's
//   decode_plan (shapes only, never the lengths, which live on the device)
//   cuts a row's slots (its page-table entries in order) into `splits`
//   contiguous runs of `span` slots, as many as fill the card's two
//   resident blocks an SM in one wave. A block walks its slots in stages of
//   64 into a ring of DEC_STAGES stages in the pool's stored type (bf16,
//   fp32, int8 or int4 bytes) by 16-byte cp.async rows, four threads a slot
//   row, which look up its page a stage ahead (slots of dead entries and
//   past the end zero-filled); masked slots are told by a slot index per
//   stage. The next stages' copies overlap this stage's math; codes become
//   floats by an exponent trick,
//   not by the quarter-rate int-to-float conversion. Eight warps: a warp
//   holds two query rows (q in registers, times the scale) and takes eight
//   keys at a time, eight lanes a key with 8 or 16 dims each (at D 96 lanes
//   0-3 16, lanes 4-7 8; shuffle reductions over those eight lanes), its
//   own online softmax (one rescale
//   per eight keys) and accumulator; at the end
//   the lanes, then the warps that share rows, are merged in a fixed order.
//   A split writes its unnormalised accumulator, m and l to an fp32
//   workspace; the last block of a (row, kv head, row block), told by an
//   acquire-release counter that it resets, merges the splits in split
//   order, folds in the separate fresh tokens (causal among themselves)
//   exactly once, and writes out and lse. Fixed orders: the same bits on
//   every run. All arithmetic is fp32 (widening a stored value is exact):
//   at T = 1 it does 4 operations a stored element pair, far under the CUDA
//   cores' rate, so device memory bounds it.
//
// - prefill, bf16 queries: flash_tile.cuh's tensor-core tile walked over
//   pages. One block owns 64 chunk rows of HPB q heads of one kv head (HPB = 2
//   where G is even: two consumer warpgroups share every K/V tile, which is
//   then loaded and converted once per kv head pair) and a producer group of
//   PF_PRODUCER_WARPS warps (two warpgroups, which give registers to the
//   consumers by setmaxnreg: 48 against 208). The producer walks only the live
//   page-table entries (slot_base >= 0 and < length; page -1 reads page 0,
//   masked) and hands 64-slot K/V tiles through a ring of PF_STAGES full/empty
//   mbarrier pairs, in the 128-byte swizzle that the wgmma descriptors name:
//   bf16 pools with ps % 64 == 0 by TMA boxes of the pool viewed as (D, NP*ps,
//   L*Hkv) (a box never crosses a page; at D 96 the second box reads zeros
//   past D); other page sizes by cp.async rows
//   gathered through the page table; int8 / int4 pools as codes and scales
//   (TMA boxes of the bytes as stored where ps % 64 == 0, else cp.async), then
//   converted a tile behind by the producer group into bf16 tiles (codes are
//   exact in bf16: the scales stay out of the tiles; the conversion, not the
//   tensor cores, bounds these pools). The chunk sits strictly after the
//   cache, so there is no causal mask: every tile is full but the one holding
//   slot `length`, whose tail is masked. Consumers: S = Q K^T by wgmma
//   m64n64k16, the scale (and the k scale) on the fp32 scores, the online
//   softmax on the fragment, e times the v scale after l took its sum, P
//   rounded to bf16 in registers as the A operand of O += P V with V through
//   the transpose bit. The tiles have flash_tile.cuh's DP stored columns,
//   and no product sums over a pad column (see there). Rounding as
//   flash_fwd's bf16 tile (Pallas bf16all):
//   bf16 operands, P rounded for PV, m, l and O in fp32. Bound by the tensor
//   cores: 4 D operations a (query, slot) pair.
// - prefill, fp32 queries: the exact CUDA-core tile of flash_tile.cuh's
//   fp32 kernel: one block per (row, q head, 64-row tile), K/V chunks of 64
//   slots staged as fp32 in shared memory, fp32 FMAs.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tile.cuh"  // NEG_INF, BQ = BK = 64, namespace tc

namespace {

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

// The 8 codes of 8 stored bytes as floats, exactly, with no int-to-float
// conversion (a quarter-rate instruction): each code plus a bias (128 for
// int8, 8 for a nibble) goes into the low byte of 2^23's mantissa, and the
// sum less 2^23 and the bias is the code. INT4: the low nibbles (dims d),
// or with HI the high ones (dims d + D/2).
template <bool INT4, bool HI = false>
__device__ __forceinline__ void codes_float(float (&f)[8], uint2 raw) {
  const uint32_t w[2] = {raw.x, raw.y};
  constexpr float OFF = 8388608.f + (INT4 ? 8.f : 128.f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t u =
        INT4 ? (((HI ? w[h] >> 4 : w[h]) & 0x0F0F0F0Fu) ^ 0x08080808u)
             : w[h] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * h + j] =
          __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - OFF;
  }
}

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
  const int* fresh_pages;  // (B,) the fresh token's page, -1: none (a
                           // sequence shard's); nullptr: from page_table
  int Hkv, NP, ps, MP, layer;
};

// The pool row (head's first page row + page) * ps + offset of the token
// at position pos of a row: entry min(pos / ps, MP - 1) of its page table
// (a row past its MP * ps slots writes into its last entry), offset pos %
// ps; -1 where that entry is unallocated (no write).
__device__ __forceinline__ long long fresh_slot(const int* table, int pos,
                                                int ps, int MP, size_t head) {
  const int page = table[min(pos / ps, MP - 1)];
  return page < 0 ? -1
                  : static_cast<long long>((head + page) * ps + pos % ps);
}

// One fresh vector (a token's k or v of one kv head: D values in src) into
// pool row `slot` by one warp. Quantized pools (scales != nullptr): the
// warp's amax, the scale amax / QMAX by an IEEE division (1 where amax is 0),
// x / scale rounded half to even (rintf) and clipped to +-QMAX, as
// quantize_kv and jnp do. A lane holds dims l + 32 i (N = D / 32 of them);
// for an int4 pool it holds instead the two dims of its bytes l + 32 i (byte
// d: dim d low, dim d + D/2 high; NB bytes, the last only where l + 32 i <
// D/2, as at D 96: 48 bytes), so the pack needs no exchange.
template <typename T, typename KV, int D>
__device__ __forceinline__ void store_vec(const T* src, void* pages,
                                          float* scales, size_t slot,
                                          int lane) {
  constexpr bool INT4 = std::is_same<KV, int4x2>::value;
  constexpr int W = PoolRow<KV, D>::W;
  constexpr float QMAX = PoolRow<KV, D>::QMAX;
  constexpr int NB = (W + 31) / 32;          // int4: bytes a lane
  constexpr int N = INT4 ? 2 * NB : D / 32;  // values a lane
  float x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (INT4) {  // x[i] and x[i + NB]: the low and high dims of
                           // byte lane + 32 i
      const int byte = lane + 32 * (i % NB);
      x[i] = byte < W ? to_float(src[byte + (i < NB ? 0 : W)]) : 0.f;
    } else {
      x[i] = to_float(src[lane + 32 * i]);
    }
  }
  if (scales != nullptr) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) amax = fmaxf(amax, fabsf(x[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = amax > 0.f ? amax / QMAX : 1.f;
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = fminf(fmaxf(rintf(x[i] / s), -QMAX), QMAX);
    if (lane == 0) scales[slot] = s;
  }
  if constexpr (INT4) {
    int8_t* dst = static_cast<int8_t*>(pages) + slot * W;
#pragma unroll
    for (int i = 0; i < NB; ++i)
      if (lane + 32 * i < W)
        dst[lane + 32 * i] =
            static_cast<int8_t>((static_cast<int>(x[i]) & 0xF) |
                                (static_cast<int>(x[i + NB]) << 4));
  } else {
    KV* dst = static_cast<KV*>(pages) + slot * W;
#pragma unroll
    for (int i = 0; i < N; ++i) store(dst + lane + 32 * i, x[i]);
  }
}

// Standalone: one block per (row, kv head), warp 0 the k vector, warp 1
// the v vector. With fresh_pages the row's page is fresh_pages[b] (-1: no
// write), as the Pallas kernel's override is.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(64) paged_store_kernel(const StoreParams p) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int kv = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head = (static_cast<size_t>(p.layer) * p.Hkv + h) * p.NP;
  const int length = p.lengths[b];
  long long slot;
  if (p.fresh_pages == nullptr) {
    slot = fresh_slot(p.page_table + static_cast<size_t>(b) * p.MP, length,
                      p.ps, p.MP, head);
  } else {
    const int page = p.fresh_pages[b];
    slot = page < 0 ? -1
                    : static_cast<long long>((head + page) * p.ps +
                                             length % p.ps);
  }
  if (slot < 0) return;
  const size_t src = (static_cast<size_t>(b) * p.Hkv + h) * D;
  store_vec<T, KV, D>(static_cast<const T*>(kv ? p.v_new : p.k_new) + src,
                      kv ? p.v_pages : p.k_pages,
                      kv ? p.v_scales : p.k_scales, slot, lane);
}

// ----------------------------------------------------------------- decode

struct DecodeParams {
  const void* q;      // (B, T, Hq, D)
  const void* k_new;  // (B, T, Hkv, D) when the fresh tokens are folded
  const void* v_new;  // or stored
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* page_table;
  const int* slot_base;
  const int* lengths;
  void* out;       // (B, T, Hq, D)
  float* lse;      // (B, Hq, T) or nullptr
  float* ws;       // splits > 1: (B, Hkv, row blocks, splits, rows, D + 2)
  int* counters;   // splits > 1: one per (B, Hkv, row block), zero; then,
                   // for a store in the fold mode over more than one block
                   // a (row, kv head), one per (B, Hkv), zero
  const int* store_n;  // (B,): fresh tokens a row stores, a prefix of the
                       // T; nullptr: all T
  const int* fresh_pages;  // (B,): store-then-attend's page (-1: none),
                           // found among the row's entries; nullptr: the
                           // entry min(length / ps, MP - 1)
  int T, Hq, Hkv, NP, ps, MP, layer;
  int fresh_in_pages, fold, store;
  int splits, span, rows;  // the plan: splits, slots a split (a multiple
                           // of DEC_CK), q rows a block (2, 4, 8 or 16)
  float scale;
};

constexpr int DEC_THREADS = 256;  // 8 warps
constexpr int DEC_CK = 64;        // page slots a stage
constexpr int DEC_STAGES = 3;     // stages in flight (2 for fp32 at D 128)
constexpr int DEC_ROWS = 16;      // query rows a block at most: two a warp
constexpr int DEC_TPR = DEC_THREADS / DEC_CK;  // threads that copy a slot
static_assert(DEC_CK % 8 == 0 && DEC_TPR >= 2, "a stage of key pairs");

template <typename KV, int D>
struct Dec {
  static constexpr int RB = PoolRow<KV, D>::W * sizeof(KV);  // bytes a slot
  static constexpr int PR = RB / 16;  // 16-byte pieces a slot
  // a stage: K slots, V slots, then the slots' global index (-1: masked)
  // and their k and v scales
  static constexpr int STAGE = 2 * DEC_CK * RB + 3 * DEC_CK * 4;
  static constexpr int STAGES =
      RB >= 512 ? (DEC_STAGES < 2 ? DEC_STAGES : 2) : DEC_STAGES;
  // a lane of a key's eight holds chunks dl + 8 i of 8 dims, i < NCH (at D
  // 96 the 12 chunks give lanes 0-3 two and lanes 4-7 one, the second
  // masked); E dims in registers
  static constexpr int NCH = (D / 8 + 7) / 8;
  static constexpr int E = 8 * NCH;
  // after the walk: the warps' states, then the block's (each row: m, l,
  // then D accumulators)
  static constexpr int STATE = 2 * DEC_ROWS * (D + 2) * 4;
  static constexpr int BYTES =
      STAGES * STAGE > STATE ? STAGES * STAGE : STATE;
};

// The dims of lane dl of a warp's key (chunks of 8 dims: dl + 8 i) from one
// slot row as stored, widened to fp32 (exact); zeros for a chunk past D.
template <typename KV, int D>
__device__ __forceinline__ void lane_dims(float (&x)[Dec<KV, D>::E],
                                          const uint8_t* row, int dl) {
#pragma unroll
  for (int i = 0; i < Dec<KV, D>::NCH; ++i) {
    const int c = dl + 8 * i;  // dims [8c, 8c + 8)
    float* o = x + 8 * i;
    if (c >= D / 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = 0.f;
      continue;
    }
    if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + 16 * c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __bfloat162float(e[j]);
    } else if constexpr (std::is_same<KV, float>::value) {
      const float4 a = *reinterpret_cast<const float4*>(row + 32 * c);
      const float4 b = *reinterpret_cast<const float4*>(row + 32 * c + 16);
      o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
      o[4] = b.x, o[5] = b.y, o[6] = b.z, o[7] = b.w;
    } else if constexpr (std::is_same<KV, int8_t>::value) {
      codes_float<false>(*reinterpret_cast<float(*)[8]>(o),
                         *reinterpret_cast<const uint2*>(row + 8 * c));
    } else {  // int4: dims < D/2 in the low nibbles, the rest in the high
      float(&oo)[8] = *reinterpret_cast<float(*)[8]>(o);
      if (8 * c >= D / 2)
        codes_float<true, true>(
            oo, *reinterpret_cast<const uint2*>(row + 8 * c - D / 2));
      else
        codes_float<true, false>(
            oo, *reinterpret_cast<const uint2*>(row + 8 * c));
    }
  }
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(DEC_THREADS, 2)
    paged_decode_kernel(const DecodeParams p) {
  using C = Dec<KV, D>;
  constexpr int E = C::E;
  // the ring on a 128-byte line: eight lanes' 16-byte reads of a slot row
  // then span one line, not two (chip_ablate.py's dec_ring_align16 variant
  // times the ring on a 16-byte boundary)
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int red[DEC_THREADS / 32];
  __shared__ int last, store_last, fresh_entry;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int split = blockIdx.z % p.splits, rb = blockIdx.z / p.splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kq = lane >> 3, dl = lane & 7;  // the lane's key of four, dims
  const int G = p.Hq / p.Hkv, R = p.T * G;
  const int RW = p.rows / 2, KS = 8 / RW;  // warps' row pairs, key slices
  const int rg = warp % RW, ks = warp / RW;
  const int row0 = rb * p.rows;  // the block's first query row
  const int nrows = min(p.rows, R - row0);
  const bool quant = p.k_scales != nullptr;
  const int length = p.lengths[b];
  const int page_end = length + (p.fresh_in_pages ? p.T : 0);
  // fresh_in_pages: slot <= length + t; otherwise slot <= length - 1
  const int lim0 = p.fresh_in_pages ? length : length - 1;
  const int tstep = p.fresh_in_pages ? 1 : 0;
  const size_t head = (static_cast<size_t>(p.layer) * p.Hkv + hk) * p.NP;
  const int* sbase = p.slot_base + static_cast<size_t>(b) * p.MP;
  const int* table = p.page_table + static_cast<size_t>(b) * p.MP;
  // The split's walk: virtual slots [v0, v1) of the row (entry j holds
  // [j ps, j ps + ps)), cut short at the last live one.
  const int V = p.MP * p.ps;
  const int v0 = min(V, split * p.span), v1 = min(V, v0 + p.span);
  int vend = v0;
  for (int j = v0 / p.ps + tid; j * p.ps < v1; j += DEC_THREADS) {
    const int sb = sbase[j];
    if (sb >= 0 && sb < page_end)
      vend = max(vend, min(v1, j * p.ps + min(p.ps, page_end - sb)));
  }
  vend = __reduce_max_sync(0xffffffffu, vend);
  if (lane == 0) red[warp] = vend;
  __syncthreads();
  vend = v0;
#pragma unroll
  for (int w = 0; w < DEC_THREADS / 32; ++w) vend = max(vend, red[w]);
  const int chunks = (vend - v0 + DEC_CK - 1) / DEC_CK;
  // the fresh tokens this row stores (uniform over the row's blocks)
  const int n_store = !p.store             ? 0
                      : p.store_n == nullptr ? p.T
                                             : min(max(p.store_n[b], 0), p.T);
  // fresh token t's k (kv 0) or v into pool row `slot` by this warp (the
  // launch writes the pool only here)
  auto put = [&](int t, int kv, size_t slot) {
    store_vec<T, KV, D>(
        static_cast<const T*>(kv ? p.v_new : p.k_new) +
            ((static_cast<size_t>(b) * p.T + t) * p.Hkv + hk) * D,
        const_cast<void*>(kv ? p.v_pages : p.k_pages),
        const_cast<float*>(kv ? p.v_scales : p.k_scales), slot, lane);
  };
  if (p.fresh_in_pages && n_store > 0 && p.MP > 0) {
    // Store, then attend (T = 1, one row block: the launch's checks). The
    // target's virtual slot lies in exactly one split's [v0, v1): that
    // block alone writes it, warp 0 the k and warp 1 the v, before any of
    // its copies; its stages then read the stored codes and scales, as a
    // read of the pool after a store launch would. No other block of the
    // launch reads or writes that slot. With fresh_pages (a sequence
    // shard's compacted table) the target is the entry holding the row's
    // fresh page; a row whose page another shard holds stores nothing.
    int j = min(length / p.ps, p.MP - 1);
    int page = table[j];
    if (p.fresh_pages != nullptr) {
      page = p.fresh_pages[b];
      if (tid == 0) fresh_entry = -1;
      __syncthreads();
      for (int e = tid; e < p.MP && page >= 0; e += DEC_THREADS)
        if (table[e] == page) atomicMax(&fresh_entry, e);
      __syncthreads();
      j = fresh_entry;
    }
    const int vt = j * p.ps + length % p.ps;
    if (j >= 0 && page >= 0 && vt >= v0 && vt < v1) {
      if (warp < 2) put(0, warp, (head + page) * p.ps + length % p.ps);
      __threadfence_block();
      __syncthreads();  // the stored slot before the block's copies
    }
  }

  // this warp's two query rows: q times the scale, in registers
  float qf[2][E], acc[2][E], m[2], l[2];
  int lim[2];
  bool live[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 2 * rg + rr, t = r / G, g = r % G;
    live[rr] = r < R;
    lim[rr] = lim0 + t * tstep;
    const T* qr = static_cast<const T*>(p.q) +
                  ((static_cast<size_t>(b) * p.T + t) * p.Hq + hk * G + g) * D;
#pragma unroll
    for (int i = 0; i < C::NCH; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        qf[rr][8 * i + j] = live[rr] && dl + 8 * i < D / 8
                                ? to_float(qr[8 * (dl + 8 * i) + j]) * p.scale
                                : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[rr][e] = 0.f;
    m[rr] = NEG_INF;
    l[rr] = 0.f;
  }

  const uint8_t* kbytes = static_cast<const uint8_t*>(p.k_pages);
  const uint8_t* vbytes = static_cast<const uint8_t*>(p.v_pages);
  // the pool row of virtual slot v, and its global slot (-1: dead, past
  // the end)
  auto source = [&](int v, int& slot) -> size_t {
    slot = -1;
    if (v >= vend) return 0;
    const int j = v / p.ps, o = v - j * p.ps;
    const int sb = sbase[j];
    if (sb < 0 || sb + o >= page_end) return 0;
    slot = sb + o;
    return (head + max(table[j], 0)) * p.ps + o;
  };
  auto stage = [&](int c) { return smem + (c % C::STAGES) * C::STAGE; };
  auto slots = [&](uint8_t* st) {
    return reinterpret_cast<int*>(st + 2 * DEC_CK * C::RB);
  };
  // DEC_TPR threads a slot row: its source is looked up once, a chunk
  // ahead of its copies (the lookup's loads then overlap a chunk's math),
  // then its K and V pieces (and scales) are copied
  const int r8 = tid / DEC_TPR, sub = tid % DEC_TPR;
  auto issue = [&](int c, size_t row, int slot) {
    if (c < chunks) {
      uint8_t* st = stage(c);
      for (int k = sub; k < 2 * C::PR; k += DEC_TPR) {
        const int kv = k / C::PR, piece = k % C::PR;
        tc::cp_async16(
            tc::smem_u32(st + (kv * DEC_CK + r8) * C::RB + 16 * piece),
            (kv ? vbytes : kbytes) + row * C::RB + 16 * piece,
            slot >= 0 ? 16 : 0);
      }
      if (sub == 0) slots(st)[r8] = slot;
      if (quant && sub < 2)
        tc::cp_async4(tc::smem_u32(slots(st) + DEC_CK * (1 + sub) + r8),
                      (sub ? p.v_scales : p.k_scales) + row,
                      slot >= 0 ? 4 : 0);
    }
    tc::cp_async_commit();
  };

  int slot_next = -1;
  size_t row_next = 0;
#pragma unroll
  for (int c = 0; c < C::STAGES - 1; ++c) {
    row_next = source(v0 + c * DEC_CK + r8, slot_next);
    issue(c, row_next, slot_next);
  }
  row_next = source(v0 + (C::STAGES - 1) * DEC_CK + r8, slot_next);
  for (int c = 0; c < chunks; ++c) {
    tc::cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // chunk c has landed; chunk c - 1's readers are done
    issue(c + C::STAGES - 1, row_next, slot_next);
    row_next = source(v0 + (c + C::STAGES) * DEC_CK + r8, slot_next);
    const uint8_t* st = stage(c);
    const int* sl = slots(const_cast<uint8_t*>(st));
    const float* sks = reinterpret_cast<const float*>(sl + DEC_CK);
    const float* svs = sks + DEC_CK;
    // two groups of four keys at a time: their scores, one max and one
    // rescale, then their values
    for (int kg = 2 * ks; kg < DEC_CK / 4; kg += 2 * KS) {
      int kk[2];
      float s[2][2];  // [group][row]
      float x[E];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        kk[h] = 4 * (kg + h) + kq;
        const int slot = sl[kk[h]];
        lane_dims<KV, D>(x, st + kk[h] * C::RB, dl);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) a = fmaf(qf[rr][e], x[e], a);
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          a += __shfl_xor_sync(0xffffffffu, a, 4);
          if (quant) a *= sks[kk[h]];
          s[h][rr] = slot >= 0 && slot <= lim[rr] ? a : NEG_INF;
        }
      }
      float corr[2], w[2][2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        corr[rr] = 1.f;
        w[0][rr] = w[1][rr] = 0.f;
        if (!live[rr]) continue;  // uniform over the warp
        float mx = fmaxf(s[0][rr], s[1][rr]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(fmaxf(m[rr], mx), NEG_INF / 2);
        corr[rr] = expf(m[rr] - m_new);
        const float e0 = expf(s[0][rr] - m_new), e1 = expf(s[1][rr] - m_new);
        l[rr] = l[rr] * corr[rr] + e0 + e1;  // this lane's keys' share
        // v's scale after l took the sum
        w[0][rr] = quant ? e0 * svs[kk[0]] : e0;
        w[1][rr] = quant ? e1 * svs[kk[1]] : e1;
        m[rr] = m_new;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lane_dims<KV, D>(x, st + (DEC_CK + kk[h]) * C::RB, dl);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          if (!live[rr]) continue;
#pragma unroll
          for (int i = 0; i < E; ++i)
            acc[rr][i] = fmaf(w[h][rr], x[i],
                              h == 0 ? acc[rr][i] * corr[rr] : acc[rr][i]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring's memory now holds the states

  if (!p.fresh_in_pages && n_store > 0) {
    // Attend the fresh tokens unquantized (folded below), and write them:
    // slots length .. length + n_store - 1, which this launch reads only
    // where a row runs past its MP * ps slots and its store lands on an
    // earlier slot of its last entry. So the last block of the (row, kv
    // head) to finish its walk writes them, after every other block of it
    // has read its slots (an acquire-release counter, which it resets);
    // one warp a vector.
    if (gridDim.z > 1) {
      if (tid == 0) {
        int* c = p.counters + gridDim.x * p.Hkv * (gridDim.z / p.splits) +
                 b * p.Hkv + hk;
        int before;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                     : "=r"(before)
                     : "l"(c)
                     : "memory");
        store_last = before == static_cast<int>(gridDim.z) - 1;
        if (store_last) *c = 0;  // ready for the next launch
      }
      __syncthreads();
    }
    if (gridDim.z == 1 || store_last) {
      for (int u = warp; u < 2 * n_store; u += DEC_THREADS / 32) {
        const int t = u >> 1, kv = u & 1;
        const long long slot =
            fresh_slot(table, length + t, p.ps, p.MP, head);
        if (slot >= 0) put(t, kv, slot);
      }
    }
  }

  // the warp's state: the four keys' lanes summed (in a fixed order)
  float* wst = reinterpret_cast<float*>(smem);  // [warp][rr][2 + D]
  float* part = wst + DEC_ROWS * (D + 2);      // the block's [row][2 + D]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lsum = l[rr] + __shfl_xor_sync(0xffffffffu, l[rr], 8);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 16);
    float* o = wst + (2 * warp + rr) * (D + 2);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      float a = acc[rr][i] + __shfl_xor_sync(0xffffffffu, acc[rr][i], 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      if (kq == 0 && dl + 8 * (i / 8) < D / 8)
        o[2 + 8 * (dl + 8 * (i / 8)) + i % 8] = a;
    }
    if (lane == 0) {
      o[0] = m[rr];
      o[1] = lsum;
    }
  }
  __syncthreads();
  // the block's rows: the key slices of each row pair merged in order
  for (int idx = tid; idx < nrows * D; idx += DEC_THREADS) {
    // row lr is row lr % 2 of warp lr / 2 + RW s in key slice s
    const int lr = idx / D, d = idx % D;
    float mx = NEG_INF;
    for (int s = 0; s < KS; ++s)
      mx = fmaxf(mx, wst[(2 * RW * s + lr) * (D + 2)]);
    float a = 0.f, ls = 0.f;
    for (int s = 0; s < KS; ++s) {
      const float* o = wst + (2 * RW * s + lr) * (D + 2);
      const float w = expf(o[0] - mx);
      a = fmaf(o[2 + d], w, a);
      ls = fmaf(o[1], w, ls);
    }
    part[lr * (D + 2) + 2 + d] = a;
    if (d == 0) {
      part[lr * (D + 2)] = mx;
      part[lr * (D + 2) + 1] = ls;
    }
  }
  __syncthreads();

  if (p.splits > 1) {
    // publish this split; the last block of the cell merges them in order
    const int cell = (b * p.Hkv + hk) * (gridDim.z / p.splits) + rb;
    const size_t span = static_cast<size_t>(p.rows) * (D + 2);
    float* ws = p.ws + static_cast<size_t>(cell) * p.splits * span;
    for (int i = tid; i < nrows * (D + 2); i += DEC_THREADS)
      ws[split * span + i] = part[i];
    __threadfence();
    __syncthreads();
    if (tid == 0) {  // release this split's partials, acquire the others'
      int before;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(before)
                   : "l"(p.counters + cell)
                   : "memory");
      last = before == p.splits - 1;
    }
    __syncthreads();
    if (!last) return;
    for (int idx = tid; idx < nrows * D; idx += DEC_THREADS) {
      const int lr = idx / D, d = idx % D;
      const float* src = ws + lr * (D + 2);
      float mx = NEG_INF;
      for (int s = 0; s < p.splits; ++s)
        mx = fmaxf(mx, __ldcg(src + s * span));
      float a = 0.f, ls = 0.f;
      for (int s = 0; s < p.splits; ++s) {
        const float ms = __ldcg(src + s * span);
        const float lsp = __ldcg(src + s * span + 1);
        if (lsp > 0.f) {  // an empty split adds nothing
          const float w = expf(ms - mx);
          a = fmaf(__ldcg(src + s * span + 2 + d), w, a);
          ls = fmaf(lsp, w, ls);
        }
      }
      part[lr * (D + 2) + 2 + d] = a;
      if (d == 0) {
        part[lr * (D + 2)] = mx;
        part[lr * (D + 2) + 1] = ls;
      }
    }
    __syncthreads();
    if (tid == 0) p.counters[cell] = 0;  // ready for the next launch
  }

  // the separate fresh tokens, causal among themselves: one warp a row,
  // lanes over D, fresh token u <= t folded in order
  if (p.fold) {
    constexpr int DL = D / 32;
    const T* kn = static_cast<const T*>(p.k_new);
    const T* vn = static_cast<const T*>(p.v_new);
    for (int lr = warp; lr < nrows; lr += DEC_THREADS / 32) {
      const int r = row0 + lr, t = r / G, g = r % G;
      float* o = part + lr * (D + 2);
      const T* qr =
          static_cast<const T*>(p.q) +
          ((static_cast<size_t>(b) * p.T + t) * p.Hq + hk * G + g) * D;
      float qv[DL], a[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        qv[i] = to_float(qr[lane + 32 * i]) * p.scale;
        a[i] = o[2 + lane + 32 * i];
      }
      float mr = o[0], lrun = o[1];
      for (int u = 0; u <= t; ++u) {
        const size_t f = ((static_cast<size_t>(b) * p.T + u) * p.Hkv + hk) * D;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < DL; ++i)
          s = fmaf(qv[i], to_float(kn[f + lane + 32 * i]), s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        const float m_new = fmaxf(fmaxf(mr, s), NEG_INF / 2);
        const float corr = expf(mr - m_new), e = expf(s - m_new);
        lrun = lrun * corr + e;
#pragma unroll
        for (int i = 0; i < DL; ++i)
          a[i] = fmaf(e, to_float(vn[f + lane + 32 * i]), a[i] * corr);
        mr = m_new;
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < DL; ++i) o[2 + lane + 32 * i] = a[i];
      if (lane == 0) {
        o[0] = mr;
        o[1] = lrun;
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out);
  for (int idx = tid; idx < nrows * D; idx += DEC_THREADS) {
    const int lr = idx / D, d = idx % D, r = row0 + lr, t = r / G, g = r % G;
    const float lsum = part[lr * (D + 2) + 1];
    store(out + ((static_cast<size_t>(b) * p.T + t) * p.Hq + hk * G + g) * D +
              d,
          part[lr * (D + 2) + 2 + d] / (lsum > 0.f ? lsum : 1.f));
  }
  if (p.lse != nullptr && tid < nrows) {
    const int r = row0 + tid, t = r / G, g = r % G;
    const float lsum = part[tid * (D + 2) + 1];
    p.lse[(static_cast<size_t>(b) * p.Hq + hk * G + g) * p.T + t] =
        lsum > 0.f ? part[tid * (D + 2)] + logf(lsum) : NEG_INF;
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
  int S, Hq, Hkv, NP, ps, MP, layer, L;
  float scale;
};

// fp32 queries: the CUDA-core tile.
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
  extern __shared__ float fsmem[];
  float* sQ = fsmem;
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

// bf16 queries: the tensor-core tile over pages.
constexpr int PF_STAGES = 3;          // K/V tiles in flight
constexpr int PF_PRODUCER_WARPS = 8;  // walk, gather, convert
constexpr int PF_TMA = 1;             // bf16 pools, ps % 64 == 0: TMA boxes
constexpr int PF_END = -1;            // a stage's count that says stop

struct PrefillTcParams {
  PrefillParams p;
  // with tma: the pool as (D, NP*ps, L*Hkv) bf16 in 64 x 64 swizzled
  // boxes, or as (RB, NP*ps, L*Hkv) code bytes in 64-row boxes and its
  // scales as (NP*ps, L*Hkv) fp32 in boxes of 64
  CUtensorMap kmap, vmap, ksmap, vsmap;
  int tma;
};

// The block's dynamic shared memory: HPB query tiles, PF_STAGES K and V
// tiles (64 rows of D bf16, swizzled, 1024-byte aligned), for a quantized
// pool two tiles' codes and scales as stored, each stage's words (its count
// of live slots or PF_END, then 64 k and 64 v scales), the walk's table of
// pool rows, and the full/empty barrier pairs.
template <typename KV, int D, int HPB>
struct Pf {
  static constexpr bool QUANT = !std::is_same<KV, __nv_bfloat16>::value;
  static constexpr int DP = tc::Smem<D>::DP;  // stored columns (as #1's)
  static constexpr int TILE = 64 * DP * 2;
  static constexpr int RB = PoolRow<KV, D>::W * sizeof(KV);  // bytes a slot
  static constexpr int RAW = QUANT ? 2 * 64 * RB + 2 * 64 * 4 : 0;
  static constexpr int PT = 32 * PF_PRODUCER_WARPS;  // producer threads
  static constexpr int THREADS = 128 * HPB + PT;
  // above 384 threads (whole warpgroups only) the registers are moved from
  // the producer warpgroups to the consumers: 65536 in all
  static constexpr int PRODUCER_REGS = 48;
  static constexpr int CONSUMER_REGS =
      (65536 / (128 * HPB) - PT / (128 * HPB) * PRODUCER_REGS) / 8 * 8 > 240
          ? 240
          : (65536 / (128 * HPB) - PT / (128 * HPB) * PRODUCER_REGS) / 8 * 8;
  static_assert(THREADS <= 384 || PT % 128 == 0, "whole warpgroups");
  static constexpr int WORDS = 2 + 2 * 64;
  static constexpr size_t BYTES = 1024 +
                                  static_cast<size_t>(TILE) *
                                      (HPB + 2 * PF_STAGES) +
                                  2 * RAW + PF_STAGES * WORDS * 4 + 64 * 8 +
                                  8 + (2 * PF_STAGES + 2) * 8;
  uint8_t* base;
  __device__ explicit Pf(uint8_t* raw) {
    base = raw + ((1024 - (tc::smem_u32(raw) & 1023)) & 1023);
  }
  __device__ uint8_t* q(int g) const { return base + TILE * g; }
  __device__ uint8_t* k(int st) const { return base + TILE * (HPB + st); }
  __device__ uint8_t* v(int st) const {
    return base + TILE * (HPB + PF_STAGES + st);
  }
  __device__ uint8_t* raw(int i) const {
    return base + TILE * (HPB + 2 * PF_STAGES) + RAW * i;
  }
  __device__ int* words(int st) const {
    return reinterpret_cast<int*>(raw(2)) + st * WORDS;
  }
  __device__ long long* table() const {
    return reinterpret_cast<long long*>(words(PF_STAGES));
  }
  __device__ uint64_t* full() const {
    return reinterpret_cast<uint64_t*>(table() + 64);
  }
  __device__ uint64_t* empty() const { return full() + PF_STAGES; }
  __device__ uint64_t* rawbar() const { return empty() + PF_STAGES; }
};

// Move this warpgroup's registers to N (setmaxnreg: INC raises, else
// lowers); every warp of the warpgroup executes it.
template <bool INC, int N>
__device__ __forceinline__ void set_max_registers() {
  if constexpr (INC)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
  else
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the producer group's own barrier (named barrier 1)
template <int PT>
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PT) : "memory");
}

// 8 codes (int8, or one nibble of 8 int4 bytes) as 8 bf16, exactly
template <bool INT4, bool HI>
__device__ __forceinline__ uint4 codes_bf16(uint2 raw) {
  float f[8];
  codes_float<INT4, HI>(f, raw);
  return make_uint4(tc::pack_bf16(f[0], f[1]), tc::pack_bf16(f[2], f[3]),
                    tc::pack_bf16(f[4], f[5]), tc::pack_bf16(f[6], f[7]));
}

template <typename KV, int D, int HPB>
__global__ void __launch_bounds__(Pf<KV, D, HPB>::THREADS, 1)
    paged_prefill_tc_kernel(const __grid_constant__ PrefillTcParams tp) {
  using Sm = Pf<KV, D, HPB>;
  using bf16 = tc::bf16;
  constexpr int PT = Sm::PT;
  const PrefillParams& p = tp.p;
  extern __shared__ uint8_t smem_raw[];
  const Sm sm(smem_raw);
  const int q0 = blockIdx.x * 64;
  const int G = p.Hq / p.Hkv, groups = G / HPB;
  const int hk = blockIdx.y / groups;
  const int h0 = hk * G + (blockIdx.y % groups) * HPB;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int length = p.lengths[b];

  // set-up: the barriers and the HPB query tiles (rows past S zero)
  if (tid == 0) {
    for (int st = 0; st < PF_STAGES; ++st) {
      tc::mbar_init(sm.full() + st, 1);
      tc::mbar_init(sm.empty() + st, 128 * HPB);
    }
    tc::mbar_init(sm.rawbar(), 1);
    tc::mbar_init(sm.rawbar() + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const bf16* q = static_cast<const bf16*>(p.q) +
                  static_cast<size_t>(b) * p.S * p.Hq * D;
  for (int idx = tid; idx < HPB * 64 * (D / 8); idx += Sm::THREADS) {
    const int g = idx / (64 * (D / 8)), rem = idx % (64 * (D / 8));
    const int r = rem / (D / 8), c = rem % (D / 8), s = q0 + r;
    const uint4 x =
        s < p.S ? *reinterpret_cast<const uint4*>(
                      q + (static_cast<size_t>(s) * p.Hq + h0 + g) * D + 8 * c)
                : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(sm.q(g)) +
                              tc::swz(r, 8 * c)) = x;
  }
  tc::fence_proxy_async();
  __syncthreads();

  if (tid >= 128 * HPB) {  // ------------------------------------ producer
    // more threads than 168 registers each allow: the producer warpgroups
    // give registers back for the consumers'
    if constexpr (Sm::THREADS > 384)
      set_max_registers<false, Sm::PRODUCER_REGS>();
    const int pt = tid - 128 * HPB;
    const int* sbase = p.slot_base + static_cast<size_t>(b) * p.MP;
    const int* ptab = p.page_table + static_cast<size_t>(b) * p.MP;
    const size_t head = (static_cast<size_t>(p.layer) * p.Hkv + hk) * p.NP;
    const int batch = p.layer * p.Hkv + hk;
    const uint8_t* kb = static_cast<const uint8_t*>(p.k_pages);
    const uint8_t* vb = static_cast<const uint8_t*>(p.v_pages);
    // a quantized tile's codes and scales (raw, as stored) into bf16 tiles
    // and the stage's scale words, by the whole producer group
    auto convert = [&](const uint8_t* raw, int st) {
      constexpr bool INT4 = std::is_same<KV, int4x2>::value;
      constexpr int U = INT4 ? D / 16 : D / 8;  // 8-byte units a row
#pragma unroll 4
      for (int idx = pt; idx < 2 * 64 * U; idx += PT) {
        const int kv = idx / (64 * U), rem = idx % (64 * U);
        const int r = rem / U, c = rem % U;
        const uint2 x = *reinterpret_cast<const uint2*>(
            raw + (kv * 64 + r) * Sm::RB + 8 * c);
        bf16* dst = reinterpret_cast<bf16*>(kv ? sm.v(st) : sm.k(st));
        if constexpr (INT4) {  // dims 8c.. low, D/2 + 8c.. high
          *reinterpret_cast<uint4*>(dst + tc::swz(r, 8 * c)) =
              codes_bf16<true, false>(x);
          *reinterpret_cast<uint4*>(dst + tc::swz(r, D / 2 + 8 * c)) =
              codes_bf16<true, true>(x);
        } else {
          *reinterpret_cast<uint4*>(dst + tc::swz(r, 8 * c)) =
              codes_bf16<false, false>(x);
        }
      }
      const float* sc = reinterpret_cast<const float*>(raw + 2 * 64 * Sm::RB);
      for (int idx = pt; idx < 128; idx += PT)
        reinterpret_cast<float*>(sm.words(st))[2 + idx] = sc[idx];
    };
    // hand tile m (nv live slots) to the consumers: its stage's count and
    // the arrival, after every producer thread's writes
    auto hand_over = [&](int m, int nv) {
      tc::fence_proxy_async();
      producer_sync<PT>();
      if (pt == 0) {
        sm.words(m % PF_STAGES)[0] = nv;
        tc::mbar_arrive(sm.full() + m % PF_STAGES);
      }
    };
    auto wait_stage = [&](int m) {
      tc::mbar_wait(sm.empty() + m % PF_STAGES, ((m / PF_STAGES) & 1) ^ 1);
    };
    int n = 0;  // tiles handed over
    if (tp.tma) {
      // live tiles of 64 slots, entry by entry (a box never crosses a page)
      int j = 0, c0 = 0, prev = 0;
      for (;;) {
        int nv = 0, row = 0;
        while (j < p.MP) {
          const int sb = sbase[j];
          const int live = sb >= 0 && sb < length ? min(p.ps, length - sb) : 0;
          if (c0 < live) {
            nv = min(64, live - c0);
            row = max(ptab[j], 0) * p.ps + c0;
            c0 += 64;
            break;
          }
          ++j;
          c0 = 0;
        }
        if constexpr (!Sm::QUANT) {  // straight into the swizzled tiles
          if (nv == 0) break;
          if (pt == 0) {
            const int st = n % PF_STAGES;
            wait_stage(n);
            sm.words(st)[0] = nv;
            uint64_t* bar = sm.full() + st;
            tc::mbar_arrive_tx(bar, 2 * (Sm::DP / 64) * tc::BOX_BYTES);
#pragma unroll
            for (int x = 0; x < Sm::DP / 64; ++x) {  // past D: zeros
              tc::tma_load(tc::smem_u32(sm.k(st)) + x * tc::BOX_BYTES,
                           &tp.kmap, bar, 64 * x, row, batch);
              tc::tma_load(tc::smem_u32(sm.v(st)) + x * tc::BOX_BYTES,
                           &tp.vmap, bar, 64 * x, row, batch);
            }
          }
          ++n;
        } else {  // codes and scales into raw, converted a tile behind
          if (nv > 0 && pt == 0) {
            uint64_t* bar = sm.rawbar() + (n & 1);
            const uint32_t raw = tc::smem_u32(sm.raw(n & 1));
            tc::mbar_arrive_tx(bar, 2 * 64 * Sm::RB + 2 * 64 * 4);
            tc::tma_load(raw, &tp.kmap, bar, 0, row, batch);
            tc::tma_load(raw + 64 * Sm::RB, &tp.vmap, bar, 0, row, batch);
            tc::tma_load(raw + 128 * Sm::RB, &tp.ksmap, bar, row, batch, 0);
            tc::tma_load(raw + 128 * Sm::RB + 256, &tp.vsmap, bar, row,
                         batch, 0);
          }
          if (n > 0) {
            tc::mbar_wait(sm.rawbar() + ((n - 1) & 1), ((n - 1) >> 1) & 1);
            wait_stage(n - 1);
            convert(sm.raw((n - 1) & 1), (n - 1) % PF_STAGES);
            hand_over(n - 1, prev);
          }
          if (nv == 0) break;
          prev = nv;
          ++n;
        }
      }
      if (pt != 0) return;
    } else {
      // the walk over live slots, 64 a tile, rows gathered through the
      // page table: entry j, slot o within it
      int j = 0, o = 0, prev = 0;
      for (;;) {
        int nv = 0;
        while (nv < 64 && j < p.MP) {
          const int sb = sbase[j];
          const int live = sb >= 0 && sb < length ? min(p.ps, length - sb) : 0;
          const int take = min(64 - nv, live - o);
          if (take > 0) {
            const long long row =
                static_cast<long long>(head + max(ptab[j], 0)) * p.ps + o;
            for (int r = nv + pt; r < nv + take; r += PT)
              sm.table()[r] = row + (r - nv);
            nv += take;
            o += take;
          }
          if (take <= 0 || o >= live) {
            ++j;
            o = 0;
          }
        }
        producer_sync<PT>();  // the table is written
        if (nv > 0) {
          const long long* tab = sm.table();
          if constexpr (Sm::QUANT) {  // codes and scales as stored
            constexpr int PR = Sm::RB / 16;
            uint8_t* raw = sm.raw(n & 1);
            for (int idx = pt; idx < 2 * 64 * PR; idx += PT) {
              const int kv = idx / (64 * PR), rem = idx % (64 * PR);
              const int r = rem / PR, piece = rem % PR;
              const bool ok = r < nv;
              tc::cp_async16(
                  tc::smem_u32(raw + (kv * 64 + r) * Sm::RB + 16 * piece),
                  (kv ? vb : kb) + (ok ? tab[r] : 0) * Sm::RB + 16 * piece,
                  ok ? 16 : 0);
            }
            for (int idx = pt; idx < 128; idx += PT) {
              const int kv = idx / 64, r = idx % 64;
              const bool ok = r < nv;
              tc::cp_async4(
                  tc::smem_u32(raw + 2 * 64 * Sm::RB + 4 * idx),
                  (kv ? p.v_scales : p.k_scales) + (ok ? tab[r] : 0),
                  ok ? 4 : 0);
            }
          } else {  // bf16 rows straight into the swizzled tiles
            const int st = n % PF_STAGES;
            wait_stage(n);
            for (int idx = pt; idx < 2 * 64 * (D / 8); idx += PT) {
              const int kv = idx / (64 * (D / 8)), rem = idx % (64 * (D / 8));
              const int r = rem / (D / 8), c = rem % (D / 8);
              const bool ok = r < nv;
              tc::cp_async16(
                  tc::smem_u32(kv ? sm.v(st) : sm.k(st)) +
                      2 * tc::swz(r, 8 * c),
                  (kv ? vb : kb) + (ok ? tab[r] : 0) * Sm::RB + 16 * c,
                  ok ? 16 : 0);
            }
          }
        }
        tc::cp_async_commit();
        if (n == 0) producer_sync<PT>();  // the table is read
        if (n > 0) {  // hand tile n - 1 over
          tc::cp_async_wait<1>();
          if constexpr (Sm::QUANT) {
            producer_sync<PT>();  // every thread's copies have landed
            wait_stage(n - 1);
            convert(sm.raw((n - 1) & 1), (n - 1) % PF_STAGES);
          }
          hand_over(n - 1, prev);
        }
        if (nv == 0) break;
        prev = nv;
        ++n;
      }
      if (pt != 0) return;
    }
    // a stage that tells the consumers to stop
    const int st = n % PF_STAGES;
    wait_stage(n);
    sm.words(st)[0] = PF_END;
    tc::mbar_arrive(sm.full() + st);
    return;
  }

  // ---------------------------------------------------------- consumers
  if constexpr (Sm::THREADS > 384)
    set_max_registers<true, Sm::CONSUMER_REGS>();
  const int g = tid / 128, t = tid % 128, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2), cq = 2 * (lane & 3);
  tc::Acc<D> acc;
#pragma unroll
  for (int i = 0; i < Sm::DP / 2; ++i) acc.o[i] = 0.f;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    acc.m[hr] = NEG_INF;
    acc.l[hr] = 0.f;
  }
  const uint32_t q_addr = tc::smem_u32(sm.q(g));
  for (int n = 0;; ++n) {
    const int st = n % PF_STAGES;
    tc::mbar_wait(sm.full() + st, (n / PF_STAGES) & 1);
    const int nv = sm.words(st)[0];
    if (nv == PF_END) break;
    const float* ksc = reinterpret_cast<const float*>(sm.words(st)) + 2;
    const float* vsc = ksc + 64;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t k_addr = tc::smem_u32(sm.k(st));
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
      tc::wgmma_ss_n64(s, tc::desc(q_addr + off, 16, 1024),
                       tc::desc(k_addr + off, 16, 1024), kk > 0);
    }
    tc::wgmma_commit();
    tc::wgmma_wait0();

#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + cq + e;
        const float kscale = Sm::QUANT ? ksc[col] : 1.f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float& x = s[4 * j + 2 * hr + e];
          x *= p.scale;
          if (Sm::QUANT) x *= kscale;
          if (col >= nv) x = NEG_INF;
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
          sum += ev;  // l sums the unscaled fp32 e
          s[4 * j + 2 * hr + e] =
              Sm::QUANT ? ev * vsc[8 * j + cq + e] : ev;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      acc.l[hr] = acc.l[hr] * corr[hr] + sum;
      acc.m[hr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < Sm::DP / 2; ++i) acc.o[i] *= corr[(i >> 1) & 1];

    // P in bf16 as wgmma's A fragment (keys 16 kk .. 16 kk + 15 of rows r0
    // and r0 + 8 are the scores' registers 8 kk .. 8 kk + 7)
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = tc::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    const uint32_t v_addr = tc::smem_u32(sm.v(st));
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      tc::wgmma_pv<Sm::DP>(acc.o, pa[kk],
                           tc::desc(v_addr + kk * 2048, 8192, 1024));
    tc::wgmma_commit();
    tc::wgmma_wait0();
    tc::mbar_arrive(sm.empty() + st);
  }

  const int h = h0 + g;
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int s = q0 + r0 + 8 * hr;
    if (s >= p.S) continue;
    const float l = acc.l[hr];
    const float l_safe = l > 0.f ? l : 1.f;
    bf16* o = out + ((static_cast<size_t>(b) * p.S + s) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + cq) =
          __floats2bfloat162_rn(acc.o[4 * j + 2 * hr] / l_safe,
                                acc.o[4 * j + 2 * hr + 1] / l_safe);
    if ((lane & 3) == 0)
      p.lse[(static_cast<size_t>(b) * p.Hq + h) * p.S + s] =
          l > 0.f ? acc.m[hr] + logf(l_safe) : NEG_INF;
  }
}

// --------------------------------------------------------------- launches

// Raise a kernel's dynamic shared-memory limit, once per device (a launch
// pays no attribute call after the first).
template <auto K>
cudaError_t allow_smem(size_t bytes) {
  static unsigned done = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && ((done >> dev) & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <typename T, typename KV, int D>
cudaError_t launch_store(const StoreParams& p, int B, cudaStream_t st) {
  paged_store_kernel<T, KV, D><<<dim3(B, p.Hkv), 64, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_decode(const DecodeParams& p, int B, cudaStream_t st) {
  using C = Dec<KV, D>;
  const int R = p.T * (p.Hq / p.Hkv);
  const int rblocks = (R + p.rows - 1) / p.rows;
  if ((p.rows != 2 && p.rows != 4 && p.rows != 8 && p.rows != DEC_ROWS) ||
      p.splits < 1 || p.span < 1 || p.span % DEC_CK != 0 ||
      static_cast<long long>(p.splits) * p.span <
          static_cast<long long>(p.MP) * p.ps ||
      (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)))
    return cudaErrorInvalidValue;
  // a store: the fresh k/v; store-then-attend at T = 1 in one row block; a
  // fold-mode store over more than one block a (row, kv head) meets on the
  // counters
  if (p.store &&
      (p.k_new == nullptr || p.v_new == nullptr ||
       (p.fresh_in_pages && (p.T != 1 || rblocks != 1)) ||
       (!p.fresh_in_pages && p.splits * rblocks > 1 && p.counters == nullptr)))
    return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem<paged_decode_kernel<T, KV, D>>(C::BYTES);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, KV, D>
      <<<dim3(B, p.Hkv, p.splits * rblocks), DEC_THREADS, C::BYTES, st>>>(p);
  return cudaGetLastError();
}

template <typename KV, int D, int HPB>
cudaError_t launch_prefill_tc(const PrefillParams& p, int B,
                              cudaStream_t st) {
  using Sm = Pf<KV, D, HPB>;
  PrefillTcParams tp{p, {}, {}, {}, {}, 0};
  if (PF_TMA && p.ps % 64 == 0) {
    const long long rows = static_cast<long long>(p.NP) * p.ps;
    const long long heads = static_cast<long long>(p.L) * p.Hkv;
    cudaError_t err;
    if constexpr (!Sm::QUANT) {
      err = tc::kv_map(&tp.kmap, p.k_pages, D, rows, heads, rows * D);
      if (err == cudaSuccess)
        err = tc::kv_map(&tp.vmap, p.v_pages, D, rows, heads, rows * D);
    } else {
      // codes and scales as they are stored: no swizzle
      const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
      const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
      const CUtensorMapSwizzle none = CU_TENSOR_MAP_SWIZZLE_NONE;
      err = tc::tiled_map(&tp.kmap, u8, p.k_pages, Sm::RB, rows, heads,
                          Sm::RB, rows * Sm::RB, Sm::RB, 64, none);
      if (err == cudaSuccess)
        err = tc::tiled_map(&tp.vmap, u8, p.v_pages, Sm::RB, rows, heads,
                            Sm::RB, rows * Sm::RB, Sm::RB, 64, none);
      if (err == cudaSuccess)
        err = tc::tiled_map(&tp.ksmap, f32, p.k_scales, rows, heads, 1,
                            rows * 4, heads * rows * 4, 64, 1, none);
      if (err == cudaSuccess)
        err = tc::tiled_map(&tp.vsmap, f32, p.v_scales, rows, heads, 1,
                            rows * 4, heads * rows * 4, 64, 1, none);
    }
    if (err != cudaSuccess) return err;
    tp.tma = 1;
  }
  const cudaError_t err =
      allow_smem<paged_prefill_tc_kernel<KV, D, HPB>>(Sm::BYTES);
  if (err != cudaSuccess) return err;
  const int G = p.Hq / p.Hkv;
  const dim3 grid((p.S + 63) / 64, p.Hkv * (G / HPB), B);
  paged_prefill_tc_kernel<KV, D, HPB><<<grid, Sm::THREADS, Sm::BYTES, st>>>(tp);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_prefill(const PrefillParams& p, int B, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // the two q heads of a kv head in one block where G is even
    const int hpb = (p.Hq / p.Hkv) % 2 == 0 ? 2 : 1;
    return hpb == 2 ? launch_prefill_tc<KV, D, 2>(p, B, st)
                    : launch_prefill_tc<KV, D, 1>(p, B, st);
  } else {
    constexpr size_t smem = prefill_smem_bytes<D>();
    const cudaError_t err = allow_smem<paged_prefill_kernel<T, KV, D>>(smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, B);
    paged_prefill_kernel<T, KV, D><<<grid, PF_THREADS, smem, st>>>(p);
    return cudaGetLastError();
  }
}

// Dispatch over (input dtype, pool type, head dim) to a launcher. kv_bits:
// 0 for a pool in the queries' dtype, 8 for int8 codes, 4 for packed int4.
template <template <typename, typename, int> class L, typename T,
          typename KV, typename P>
cudaError_t dispatch_dim(const P& p, int B, int D, cudaStream_t st) {
  return D == 64   ? L<T, KV, 64>::run(p, B, st)
         : D == 96 ? L<T, KV, 96>::run(p, B, st)
                   : L<T, KV, 128>::run(p, B, st);
}

template <template <typename, typename, int> class L, typename T, typename P>
cudaError_t dispatch_pool(const P& p, int B, int D, int kv_bits,
                          cudaStream_t st) {
  if (kv_bits == 8) return dispatch_dim<L, T, int8_t>(p, B, D, st);
  if (kv_bits == 4) return dispatch_dim<L, T, int4x2>(p, B, D, st);
  return dispatch_dim<L, T, T>(p, B, D, st);
}

template <template <typename, typename, int> class L, typename P>
cudaError_t dispatch(const P& p, int B, int D, int is_bf16, int kv_bits,
                     cudaStream_t st) {
  if ((D != 64 && D != 96 && D != 128) ||
      (kv_bits != 0 && kv_bits != 8 && kv_bits != 4))
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
                                const int* lengths, const int* fresh_pages,
                                int B, int Hkv, int NP, int ps, int D, int MP,
                                int layer, int is_bf16, int kv_bits,
                                void* stream) {
  const StoreParams p{k_new,      v_new,   k_pages, v_pages, k_scales,
                      v_scales,   page_table, lengths, fresh_pages, Hkv,
                      NP,         ps,      MP,      layer};
  return static_cast<int>(dispatch<Store>(p, B, D, is_bf16, kv_bits,
                                          static_cast<cudaStream_t>(stream)));
}

// The plan (splits, span, rows) and, for splits > 1, the workspace and
// zeroed counters come from the wrapper (ops/paged_attention.py:
// decode_plan). store: write the fresh k/v of the first store_n[b] (all T
// where store_n is NULL) tokens of each row into the pool, in this launch;
// fresh_pages (T = 1 store-then-attend only): each row's page, -1 for none.
extern "C" int v2pe_paged_decode(
    const void* q, const void* k_new, const void* v_new, const void* k_pages,
    const void* v_pages, const float* k_scales, const float* v_scales,
    const int* page_table, const int* slot_base, const int* lengths,
    void* out, float* lse, int B, int T, int Hq, int Hkv, int NP, int ps,
    int D, int MP, int layer, int is_bf16, int kv_bits, int fresh_in_pages,
    int fold, float scale, int splits, int span, int rows, float* ws,
    int* counters, int store, const int* store_n, const int* fresh_pages,
    void* stream) {
  const DecodeParams p{q,          k_new,      v_new,   k_pages, v_pages,
                       k_scales,   v_scales,   page_table, slot_base,
                       lengths,    out,        lse,     ws,      counters,
                       store_n,    fresh_pages, T,      Hq,      Hkv,  NP,
                       ps,         MP,         layer,   fresh_in_pages,
                       fold,       store,      splits,  span,    rows,
                       scale};
  return static_cast<int>(dispatch<Decode>(p, B, D, is_bf16, kv_bits,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int v2pe_paged_prefill(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales, const int* page_table,
    const int* slot_base, const int* lengths, void* out, float* lse, int B,
    int S, int Hq, int Hkv, int NP, int ps, int D, int MP, int layer,
    int is_bf16, int kv_bits, float scale, int L, void* stream) {
  const PrefillParams p{q,        k_pages,  v_pages, k_scales, v_scales,
                        page_table, slot_base, lengths, out,   lse,
                        S,        Hq,       Hkv,     NP,       ps,
                        MP,       layer,    L,       scale};
  return static_cast<int>(dispatch<Prefill>(p, B, D, is_bf16, kv_bits,
                                            static_cast<cudaStream_t>(stream)));
}
