// Weight-only int8 / int4 matrix products for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of v2pe_tpu/ops/quantized_matmul.py:
//   qdot_kernel          <- _qdot_kernel          (wrapper quantized_dot)
//   qdot_stacked_kernel  <- _qdot_stacked_kernel  (quantized_dot_stacked)
//   q4dot_kernel         <- _q4dot_kernel         (quantized_dot, int4)
//   q4dot_stacked_kernel <- _q4dot_stacked_kernel (quantized_dot_stacked)
// Layouts as in JAX. int8: codes (L, D, Npad) int8, scale (L, 1, Npad) fp32,
// out = (bf16(x) . codes) * scale. int4: bytes (L, D/2, Npad), byte [d] holds
// row d in its low nibble and row d + D/2 in its high nibble; scale
// (L, D/gs, Npad) fp32, one per group of gs contracted rows; each weight is
// dequantized as bf16(nibble * scale), one fp32 product rounded once, and
// out = bf16(x) . w. x (M, D) is bf16 or fp32 and is rounded to bf16 either
// way; products accumulate in fp32; out (M, n_out) is fp32 or bf16, and only
// n_out of the Npad columns are written. The stacked kernels take the whole
// stack and a layer index and read that layer in place, as the Pallas index
// maps do. The codes are read as they lie: nothing is repacked.
//
// Design. The TPU kernels hand (bm, D) x (D, bn) blocks in VMEM to the
// matrix unit. Here both bodies run bf16 products on the tensor cores with
// the weights dequantized on chip; the launch plan (body, column tile,
// splits of the depth, grid, workspace) is computed by the wrapper
// (ops/quantized_matmul.py:launch_plan) and checked here (valid()).
//
// - M <= 16 (decode, the vocab head): "strip". Every weight byte is read
//   once for 2 M operations, so device memory bounds it (w1: 16.8 MB of
//   int8 codes, 5 us at 3.35 TB/s) and the aim is bytes in flight. A block
//   of 8 warps owns bn = 32, 64 or 128 output columns and one split of the
//   depth; the codes of its split stream through a ring of shared-memory
//   stages by cp.async, 16 bytes a copy (int8: 4 stages of 8 KB, int4: 6 of
//   4 KB; bn columns x 8192 / bn or 4096 / bn rows, rows padded by 16 bytes
//   so that the fragment reads below meet no bank conflict). Each warp takes 16 rows
//   x 32 columns of a stage: a lane reads 4 bytes (4 columns) from each of
//   the rows 2q, 2q + 1, 2q + 8, 2q + 9 (lane = 4 g + q), which is the A
//   fragment of two mma.sync m16n8k16 products in which the weight is the
//   16-row operand (the columns of the output) and x the 8-column one (rows
//   of x, 8 or 16, zero-padded in registers: M = 1 costs what M = 8 does,
//   and wide loads cost no registers per row of x). int8 codes become bf16
//   exactly by the float exponent trick (no int-to-float conversion); int4
//   nibbles the same way, times their group's scale, read once per group,
//   and rounded once to bf16. x of the split is staged once in shared memory
//   as bf16. The depth is split over blocks so that every product launches
//   at least two blocks a SM (w2: 16 column tiles x 18 splits); a split's
//   fp32 partial sums go to a workspace, and the last block of a column tile
//   (a per-tile counter taken with one acquire-release atomic, reset by that
//   block) sums them in split order, applies the scale and casts: no float
//   atomics, the same inputs give the same bits. What is left above the
//   bound is fixed cost: a launch (~2.4 us), the ring's first fill, the
//   split's meeting, against ~5-10 us of streaming.
// - M > 16 (prefill, session chunks): "wgmma". The operations bound it (the
//   8-tile prompt's wqkv is 36 GFLOP, 0.037 ms, against 8 MB of codes);
//   what held a first version back was turning codes into bf16: staged
//   through shared memory (dequantize, fence, two block barriers a tile) it
//   was 2-3x the products' time. So the product is turned round, out^T =
//   W^T x^T, as mixed-input GEMMs do: a block owns a 128-column x 128-row
//   output tile; each consumer warpgroup's 64 output columns are wgmma's M
//   operand, built in registers straight from the code tile (a lane reads 2
//   bytes from each of 4 rows of a 16-row step: its A fragment), and x's
//   bf16 tile (128 rows, K-major) is the B operand from shared memory. One
//   producer warp keeps TC_STAGES stages in flight by TMA (codes: a 64-row
//   x 128-byte box of the stack at row li * K + k; x: a 128-row x 64-column
//   box, one per half of the depth for int4), guarded by full/empty
//   mbarriers; the two warpgroups never wait for each other. int8 codes
//   become bf16 by the exponent trick, int4 as bf16(nibble * scale) with
//   the lane's two columns' group scales in registers; one code tile
//   yields the fragments of both halves of the depth, the low nibbles
//   against x's columns [k, k + 64) and the high ones against
//   [D/2 + k, D/2 + k + 64), into the same accumulator, so the packed bytes
//   are read once. A warpgroup waits for a tile's products before it
//   builds the next tile's fragments (ptxas serializes wgmma whose register
//   operands are written while products are in flight); the two
//   warpgroups keep the tensor cores busy in turn. For fp32 output the
//   tensor cores' sums are added into the fp32 accumulator every
//   PROMOTE_TILES tiles (a long depth otherwise drifts ~1e-5 of the range
//   from fp32 sums in order). The epilogue applies the int8 scale, casts,
//   masks M's ragged edge and writes only n_out columns. bf16 x that TMA
//   cannot address (fp32 x is rounded by the wrapper) is staged by the
//   producer warp. The codes' tensor map depends only on the stack: it is
//   encoded once per (address, shape) and kept; x's per call.

#include <mutex>

#include "hopper.cuh"

namespace {

using tc::bf16;

struct QdotParams {
  const void* x;       // (M, D) bf16 or fp32
  const int8_t* w;     // the stack: int8 codes (L, K, Npad), K = D or D/2
  const float* scale;  // (L, 1, Npad) or (L, D/gs, Npad)
  void* out;           // (M, n_out) fp32 or bf16
  float* ws;           // (splits, M, Npad) fp32 partial sums, splits > 1
  int* counters;       // one per column tile, zero between launches
  int li, L;           // layer of the stack, layers
  int M, D, K, Npad, n_out;
  int gs;              // int4: contracted rows per scale group
  int x_bf16, out_bf16;
  int bn, splits, split_rows;  // strip: columns a block, the depth's split
};

struct Launch {
  CUtensorMap wmap;  // wgmma: the codes, (Npad, K, L) bytes
  CUtensorMap xmap;  // wgmma: x, (D, M, 1) bf16, when x_tma
  QdotParams p;
  int x_tma;
};

__device__ __forceinline__ const int8_t* layer_codes(const QdotParams& p) {
  return p.w + static_cast<size_t>(p.li) * p.K * p.Npad;
}

template <bool INT4>
__device__ __forceinline__ const float* layer_scale(const QdotParams& p) {
  return p.scale + static_cast<size_t>(p.li) * (INT4 ? p.D / p.gs : 1) *
                       p.Npad;
}

// x[i] rounded to bf16
__device__ __forceinline__ bf16 load_x(const QdotParams& p, size_t i) {
  if (p.x_bf16) return static_cast<const bf16*>(p.x)[i];
  return __float2bfloat16_rn(static_cast<const float*>(p.x)[i]);
}

__device__ __forceinline__ void store_out(const QdotParams& p, size_t i,
                                          float v) {
  if (p.out_bf16)
    static_cast<bf16*>(p.out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p.out)[i] = v;
}

// Dequantization. A code byte b (or nibble) becomes the float 2^23 + u with
// u = b + 128 (nibble + 8) in the low mantissa bits by one byte permute, then
// exactly b by one subtraction.
constexpr float MAGIC8 = 8388736.f;  // 2^23 + 128
constexpr float MAGIC4 = 8388616.f;  // 2^23 + 8

// byte j of u (already offset) as a float, minus magic
__device__ __forceinline__ float byte_float(uint32_t u, int j, float magic) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)),
                   magic);
}

// two small integers held exactly in fp32 as a bf16 pair (lo in the low
// half): their upper halves, no rounding needed
__device__ __forceinline__ uint32_t int_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return tc::pack_bf16(lo, hi);
}

// int8: the 4 codes of a word (+128 each) as floats
__device__ __forceinline__ void codes8(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = byte_float(u, j, MAGIC8);
}

// int4: the 4 low and the 4 high nibbles of a word as floats
__device__ __forceinline__ void nibbles(uint32_t w, float (&lo)[4],
                                        float (&hi)[4]) {
  const uint32_t u = w ^ 0x88888888u;
  const uint32_t l4 = u & 0x0F0F0F0Fu, h4 = (u >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = byte_float(l4, j, MAGIC4);
    hi[j] = byte_float(h4, j, MAGIC4);
  }
}

// ------------------------------------------------------------ M <= 16

constexpr int STRIP_THREADS = 256;   // 8 warps
// a stage's code bytes (bn x tile / bn rows; rows padded by 16 bytes in
// the slot, half as much again at bn 32) and the stages of the ring
template <bool INT4>
struct Strip {
  static constexpr int TILE = INT4 ? 4096 : 8192;
  static constexpr int SLOT = TILE * 3 / 2;
  static constexpr int STAGES = INT4 ? 6 : 4;
};
constexpr int STRIP_ROWS = 2048;     // x rows a split stages at most
constexpr int STRIP_MIN_BLOCKS = 4;  // resident blocks a SM planned at MT 8

__host__ __device__ constexpr int strip_xp(int split_rows) {
  return (split_rows + 255) / 256 * 256 + 8;  // x row stride (bf16 elements)
}

template <bool INT4>
__host__ __device__ constexpr size_t strip_smem(int M, int split_rows) {
  return static_cast<size_t>(Strip<INT4>::STAGES) * Strip<INT4>::SLOT +
         static_cast<size_t>(INT4 ? 2 : 1) * M * strip_xp(split_rows) * 2;
}

// UNIFORM (int8, and int4 with gs a multiple of 16): every 16-row slice
// lies in one scale group.
template <int MT, bool INT4, bool UNIFORM>
__device__ void strip_run(const QdotParams& p) {
  constexpr int H = INT4 ? 2 : 1;  // halves of x a code row meets
  constexpr int MB = MT / 8;       // blocks of 8 rows of x
  constexpr int STAGES = Strip<INT4>::STAGES, SLOT = Strip<INT4>::SLOT;
  constexpr int PER = Strip<INT4>::TILE / 4096;  // 16-row slices a warp a stage
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bn = p.bn, wn = bn / 32, bk = Strip<INT4>::TILE / bn,
            P = bn + 16;
  const int cg = warp % wn, ks = warp / wn;  // column group, row slice
  const int tile = blockIdx.x, split = blockIdx.y, n0 = tile * bn;
  const int k_begin = split * p.split_rows;
  const int rows = min(p.K, k_begin + p.split_rows) - k_begin;
  const int steps = (rows + bk - 1) / bk, XP = strip_xp(p.split_rows);
  const int8_t* w = layer_codes(p);
  const float* scale = layer_scale<INT4>(p);
  bf16* xs = reinterpret_cast<bf16*>(smem + STAGES * SLOT);

  // 16-byte copies, PER a thread a stage; rows past the split arrive as
  // zeros
  auto issue = [&](int t) {
    if (t < steps) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = tid + i * STRIP_THREADS;
        const int cr = c / (bn / 16), cc = c % (bn / 16);
        const int r = t * bk + cr;
        const bool ok = r < rows;
        tc::cp_async16(
            tc::smem_u32(smem + (t % STAGES) * SLOT + cr * P + 16 * cc),
            w + static_cast<size_t>(k_begin + (ok ? r : 0)) * p.Npad + n0 +
                16 * cc,
            ok ? 16 : 0);
      }
    }
    tc::cp_async_commit();
  };
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  // x of the split, rounded to bf16: [half][row of x][contracted row]
  const int xr = steps * bk;
  for (int i = tid; i < H * p.M * xr; i += STRIP_THREADS) {
    const int r = i % xr, m = (i / xr) % p.M, h = i / (xr * p.M);
    xs[(h * p.M + m) * XP + r] =
        r < rows ? load_x(p, static_cast<size_t>(m) * p.D + h * (p.D / 2) +
                                 k_begin + r)
                 : __float2bfloat16_rn(0.f);
  }

  float acc[MB][2][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mb][t2][e] = 0.f;

  // int4: this lane's 4 columns' scales of the group in use (low, high half)
  const int col = n0 + cg * 32 + 4 * g;
  const int G2 = INT4 ? p.D / p.gs / 2 : 0;
  int held = -1;
  float4 s_lo = make_float4(0.f, 0.f, 0.f, 0.f), s_hi = s_lo;
  auto scales = [&](int grp) {
    // (rows past the depth hold zero codes: any real group will do)
    grp = min(grp, G2 - 1);
    if (grp != held) {
      s_lo = *reinterpret_cast<const float4*>(
          scale + static_cast<size_t>(grp) * p.Npad + col);
      s_hi = *reinterpret_cast<const float4*>(
          scale + static_cast<size_t>(grp + G2) * p.Npad + col);
      held = grp;
    }
  };

  for (int t = 0; t < steps; ++t) {
    tc::cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(t + STAGES - 1);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int sr = 16 * (ks + i * (8 / wn));  // the slice in the stage
      const int kr = t * bk + sr;  // ... and in the split
      if (kr >= rows) continue;
      const uint8_t* st = smem + (t % STAGES) * SLOT +
                          (sr + 2 * q) * P + cg * 32 + 4 * g;
      const uint32_t wr[4] = {
          *reinterpret_cast<const uint32_t*>(st),
          *reinterpret_cast<const uint32_t*>(st + P),
          *reinterpret_cast<const uint32_t*>(st + 8 * P),
          *reinterpret_cast<const uint32_t*>(st + 9 * P)};
      // B fragments: rows g (+8) of x at contracted rows kr + 2q (+1, +8, +9)
      uint32_t b[H][MB][2];
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const int m = 8 * mb + g;
          b[h][mb][0] = b[h][mb][1] = 0u;
          if (m < p.M) {
            const bf16* xrow = xs + (h * p.M + m) * XP + kr + 2 * q;
            b[h][mb][0] = *reinterpret_cast<const uint32_t*>(xrow);
            b[h][mb][1] = *reinterpret_cast<const uint32_t*>(xrow + 8);
          }
        }
      // A fragments: a[t2] covers columns 2 t2 (rows g of the product) and
      // 2 t2 + 1 (rows g + 8) of the lane's 4; f[row][column], rows 2q,
      // 2q + 1, 2q + 8, 2q + 9
      uint32_t a[H][2][4];
      float f[H][4][4];
      if constexpr (!INT4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) codes8(wr[r], f[0][r]);
      } else {
        const int r_lane[4] = {2 * q, 2 * q + 1, 2 * q + 8, 2 * q + 9};
        if (UNIFORM) scales((k_begin + kr) / p.gs);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (!UNIFORM) scales((k_begin + kr + r_lane[r]) / p.gs);
          nibbles(wr[r], f[0][r], f[H - 1][r]);
          const float sl[4] = {s_lo.x, s_lo.y, s_lo.z, s_lo.w};
          const float sh[4] = {s_hi.x, s_hi.y, s_hi.z, s_hi.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            f[0][r][j] = __fmul_rn(f[0][r][j], sl[j]);
            f[H - 1][r][j] = __fmul_rn(f[H - 1][r][j], sh[j]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int t2 = 0; t2 < 2; ++t2) {
          const int c0 = 2 * t2, c1 = 2 * t2 + 1;
          if constexpr (INT4) {  // each weight rounded once to bf16
            a[h][t2][0] = bf16_pair(f[h][0][c0], f[h][1][c0]);
            a[h][t2][1] = bf16_pair(f[h][0][c1], f[h][1][c1]);
            a[h][t2][2] = bf16_pair(f[h][2][c0], f[h][3][c0]);
            a[h][t2][3] = bf16_pair(f[h][2][c1], f[h][3][c1]);
          } else {  // codes are exact in bf16
            a[h][t2][0] = int_pair(f[h][0][c0], f[h][1][c0]);
            a[h][t2][1] = int_pair(f[h][0][c1], f[h][1][c1]);
            a[h][t2][2] = int_pair(f[h][2][c0], f[h][3][c0]);
            a[h][t2][3] = int_pair(f[h][2][c1], f[h][3][c1]);
          }
        }
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int t2 = 0; t2 < 2; ++t2)
            tc::mma_16816(acc[mb][t2], a[h][t2], b[h][mb]);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // the row slices' sums meet in shared memory: [slice][row of x][column]
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int t2 = 0; t2 < 2; ++t2) {
      const int c = cg * 32 + 4 * g + 2 * t2, m = 8 * mb + 2 * q;
      red[(ks * MT + m) * bn + c] = acc[mb][t2][0];
      red[(ks * MT + m + 1) * bn + c] = acc[mb][t2][1];
      red[(ks * MT + m) * bn + c + 1] = acc[mb][t2][2];
      red[(ks * MT + m + 1) * bn + c + 1] = acc[mb][t2][3];
    }
  __syncthreads();
  const int slices = 8 / wn;
  if (p.splits == 1) {
    for (int i = tid; i < p.M * bn; i += STRIP_THREADS) {
      const int m = i / bn, n = n0 + i % bn;
      if (n >= p.n_out) continue;
      float v = 0.f;
      for (int s = 0; s < slices; ++s) v += red[(s * MT + m) * bn + i % bn];
      if (!INT4) v *= scale[n];
      store_out(p, static_cast<size_t>(m) * p.n_out + n, v);
    }
    return;
  }
  // a split: partial sums to the workspace; the tile's last block sums the
  // splits in order
  for (int i = tid; i < p.M * bn; i += STRIP_THREADS) {
    const int m = i / bn;
    float v = 0.f;
    for (int s = 0; s < slices; ++s) v += red[(s * MT + m) * bn + i % bn];
    p.ws[(static_cast<size_t>(split) * p.M + m) * p.Npad + n0 + i % bn] = v;
  }
  __syncthreads();
  __shared__ int last;
  if (tid == 0) {  // release this block's partials, acquire the others'
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before)
                 : "l"(p.counters + tile)
                 : "memory");
    last = before == p.splits - 1;
  }
  __syncthreads();
  if (!last) return;
  constexpr int BATCH = 8;  // partials in flight a thread, summed in order
  for (int i = tid; i < p.M * bn; i += STRIP_THREADS) {
    const int m = i / bn, n = n0 + i % bn;
    if (n >= p.n_out) continue;
    const float* src = p.ws + static_cast<size_t>(m) * p.Npad + n;
    const size_t step = static_cast<size_t>(p.M) * p.Npad;
    float v = 0.f;
    for (int s0 = 0; s0 < p.splits; s0 += BATCH) {
      float part[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
        part[j] = s0 + j < p.splits ? __ldcg(src + (s0 + j) * step) : 0.f;
#pragma unroll
      for (int j = 0; j < BATCH; ++j)
        if (s0 + j < p.splits) v += part[j];
    }
    if (!INT4) v *= scale[n];
    store_out(p, static_cast<size_t>(m) * p.n_out + n, v);
  }
  if (tid == 0) p.counters[tile] = 0;
}

// ------------------------------------------------------------- M > 16

constexpr int TC_BM = 128, TC_BN = 128, TC_BK = 64;
constexpr int TC_CONSUMERS = 256;  // two warpgroups, 64 rows of x each
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // + the producer warp

template <bool INT4>
struct TcSmem {
  static constexpr int H = INT4 ? 2 : 1;
  static constexpr int STAGES = INT4 ? 5 : 8;
  static constexpr int CODE = TC_BK * TC_BN;      // a code box, bytes
  static constexpr int XT = TC_BM * TC_BK * 2;    // an x box
  static constexpr int SLOT = CODE + H * XT;
  static constexpr size_t BYTES = 1024 + STAGES * SLOT + 2 * STAGES * 8;
  uint8_t* base;
  __device__ explicit TcSmem(uint8_t* raw) {
    base = raw + ((1024 - (tc::smem_u32(raw) & 1023)) & 1023);
  }
  __device__ uint8_t* code(int st) const { return base + st * SLOT; }
  __device__ uint8_t* x(int st, int h) const {
    return base + st * SLOT + CODE + h * XT;
  }
  __device__ uint64_t* full() const {
    return reinterpret_cast<uint64_t*>(base + STAGES * SLOT);
  }
  __device__ uint64_t* empty() const { return full() + STAGES; }
};

// The producer warp stages x's tile by hand (bf16 x that TMA cannot
// address; the wrapper rounds fp32 x to bf16 for this body): rows
// [m0, m0 + 128) x columns [c0, c0 + 64), zeros past M and D, in the
// 128-byte swizzle of a TMA box.
__device__ void stage_x(const QdotParams& p, uint8_t* dst, int m0, int c0) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < TC_BM * 8; i += 32) {
    const int r = i / 8, ch = i % 8, m = m0 + r, c = c0 + 8 * ch;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (m < p.M) {
      const size_t at = static_cast<size_t>(m) * p.D + c;
      bf16 e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = c + j < p.D ? load_x(p, at + j) : __float2bfloat16_rn(0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = static_cast<uint32_t>(__bfloat16_as_ushort(e[2 * j])) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(e[2 * j + 1]))
                << 16);
    }
    *reinterpret_cast<uint4*>(dst + r * 128 + ((ch ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// A warp's A fragments of one 16-row step of a code tile (TMA's 128-byte
// swizzle): the weight is the 16-row operand of the product, its rows g
// and g + 8 the lane's two columns col and col + 1 (lane = 4 g + q), its k
// the code rows 2q, 2q + 1 (regs 0, 1) and 2q + 8, 2q + 9 (regs 2, 3) from
// row r0. int4 fills both halves' fragments (lo: the low nibbles, rows of
// the first half of the depth; hi: the high ones), each weight bf16(nibble
// * scale) with the scale of its row's group (s: lo, hi; columns col,
// col + 1; reloaded when the group changes).
template <bool INT4>
struct Frags {
  int held = -1;
  float s[2][2];

  // the lane's scales of group grp (low half, high half; columns n, n + 1)
  // (rows past the depth hold zero codes: any real group will do)
  __device__ void group(const QdotParams& p, const float* scale, int grp,
                        int n) {
    const int G2 = p.D / p.gs / 2;
    grp = min(grp, G2 - 1);
    if (grp == held) return;
    const float2 sl = *reinterpret_cast<const float2*>(
        scale + static_cast<size_t>(grp) * p.Npad + n);
    const float2 sh = *reinterpret_cast<const float2*>(
        scale + static_cast<size_t>(grp + G2) * p.Npad + n);
    s[0][0] = sl.x, s[0][1] = sl.y, s[1][0] = sh.x, s[1][1] = sh.y;
    held = grp;
  }

  // fixed: the caller has loaded the step's group (int4)
  __device__ void build(const QdotParams& p, const float* scale,
                        const uint8_t* code, int r0, int k, int col,
                        int n, bool fixed, uint32_t (&lo)[4],
                        uint32_t (&hi)[4]) {
    const int q = (threadIdx.x & 31) & 3;
    uint32_t h[4];  // the two codes (col, col + 1) of rows 2q, +1, +8, +9
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 2 * q + (i & 1) + 8 * (i >> 1);
      h[i] = *reinterpret_cast<const uint16_t*>(
          code + r * 128 + (((col >> 4) ^ (r & 7)) << 4) + (col & 15));
    }
    // rows (2q, 2q + 1) and (2q + 8, 2q + 9): bytes col, col + 1 of each
    const uint32_t w[2] = {h[0] | (h[1] << 16), h[2] | (h[3] << 16)};
    if constexpr (!INT4) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float f[4];
        codes8(w[i], f);
        lo[2 * i] = int_pair(f[0], f[2]);      // column col
        lo[2 * i + 1] = int_pair(f[1], f[3]);  // column col + 1
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float fl[4], fh[4];
        nibbles(w[i], fl, fh);
        float v[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // byte e: row 2q (+8) + e / 2
          if (!fixed && (e & 1) == 0)
            group(p, scale, (k + r0 + 2 * q + 8 * i + (e >> 1)) / p.gs, n);
          v[0][e] = __fmul_rn(fl[e], s[0][e & 1]);
          v[1][e] = __fmul_rn(fh[e], s[1][e & 1]);
        }
        lo[2 * i] = bf16_pair(v[0][0], v[0][2]);
        lo[2 * i + 1] = bf16_pair(v[0][1], v[0][3]);
        hi[2 * i] = bf16_pair(v[1][0], v[1][2]);
        hi[2 * i + 1] = bf16_pair(v[1][1], v[1][3]);
      }
    }
  }
};

// PROMOTE (fp32 out): the tensor cores' fp32 sums are carried over
// PROMOTE_TILES code tiles at a time and then added into the accumulator
// by fp32 adds, so that a long depth keeps fp32's accuracy.
constexpr int PROMOTE_TILES = 4;

// out^T = W^T x^T: a warpgroup's 64 output columns are the wgmma's M, built
// in registers from the codes; x's tile (128 rows, K-major) is B.
template <bool INT4, bool PROMOTE>
__device__ void tc_body(const Launch& lp) {
  using Sm = TcSmem<INT4>;
  constexpr int H = Sm::H, S = Sm::STAGES, KK = TC_BK / 16;
  const QdotParams& p = lp.p;
  extern __shared__ uint8_t smem_raw[];
  const Sm sm(smem_raw);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TC_BM, n0 = blockIdx.y * TC_BN;
  const int nk = (p.K + TC_BK - 1) / TC_BK;  // code tiles of the depth
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      tc::mbar_init(sm.full() + st, lp.x_tma ? 1 : 2);
      tc::mbar_init(sm.empty() + st, TC_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {  // the producer warp
    const int lane = tid & 31;
    for (int t = 0; t < nk; ++t) {
      const int st = t % S, lap = t / S, k = t * TC_BK;
      if (lap > 0) tc::mbar_wait(sm.empty() + st, (lap - 1) & 1);
      uint64_t* bar = sm.full() + st;
      if (lane == 0) {
        tc::mbar_arrive_tx(bar, Sm::CODE + (lp.x_tma ? H * Sm::XT : 0));
        tc::tma_load(tc::smem_u32(sm.code(st)), &lp.wmap, bar, n0, k, p.li);
        if (lp.x_tma)
          for (int h = 0; h < H; ++h)
            tc::tma_load(tc::smem_u32(sm.x(st, h)), &lp.xmap, bar,
                         h * (p.D / 2) + k, m0, 0);
      }
      if (!lp.x_tma) {
        for (int h = 0; h < H; ++h)
          stage_x(p, sm.x(st, h), m0, h * (p.D / 2) + k);
        tc::fence_proxy_async();
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(bar);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns output columns [64 wg, 64 wg + 64) of the
  // tile; warp w of it rows 16 w .. 16 w + 15 of the product, which are the
  // columns col = 64 wg + 16 w + 2 g (product row g) and col + 1 (row g + 8)
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int col = 64 * (tid / 128) + 16 * ((tid / 32) % 4) + 2 * g;
  const int n = n0 + col;  // the first of the lane's two output columns
  const float* scale = layer_scale<INT4>(p);
  Frags<INT4> fr;
  float acc[64], part[64];  // part: PROMOTE only
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // one set of fragments: a tile's products are waited for before the
  // next tile's fragments are built (the compiler serializes wgmma whose
  // register operands are written while products are in flight); the two
  // warpgroups, which never wait for each other, keep the tensor cores
  // busy in turn
  uint32_t a[H][KK][4];
  for (int t = 0; t < nk; ++t) {
    const int st = t % S;
    tc::mbar_wait(sm.full() + st, (t / S) & 1);
    // int4 with whole code tiles in one group (gs 64, 128): the scales of
    // the tile's group, once, then fragments with no group arithmetic
    const bool whole = INT4 && p.gs % TC_BK == 0;
    if (whole) fr.group(p, scale, t * TC_BK / p.gs, n);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      fr.build(p, scale, sm.code(st), 16 * kk, t * TC_BK, col, n,
               whole, a[0][kk], a[H - 1][kk]);
    __syncwarp();
    tc::wgmma_fence();
    const bool fresh = PROMOTE && t % PROMOTE_TILES == 0;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const uint32_t xa = tc::smem_u32(sm.x(st, h));
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint64_t db = tc::desc(xa + kk * 32, 16, 1024);
        if constexpr (PROMOTE)
          tc::wgmma_rs_n128<0>(part, a[h][kk], db,
                               !(fresh && h == 0 && kk == 0));
        else
          tc::wgmma_rs_n128<0>(acc, a[h][kk], db, 1);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait0();
    if constexpr (PROMOTE) {
      if (t % PROMOTE_TILES == PROMOTE_TILES - 1 || t == nk - 1)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
    if (lane == 0) tc::mbar_arrive(sm.empty() + st);
  }
  tc::wgmma_wait0();

  // acc[4 j + 2 hr + e]: output column n + hr, row m0 + 8 j + 2 q + e
  const int mq = m0 + 2 * q;
  float sc[2] = {1.f, 1.f};
  if (!INT4)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) sc[hr] = scale[n + hr];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = mq + 8 * j + e;
      if (m >= p.M) continue;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (n + hr < p.n_out)
          store_out(p, static_cast<size_t>(m) * p.n_out + n + hr,
                    acc[4 * j + 2 * hr + e] * sc[hr]);
    }
}

// MT = 8 or 16 rows of x (strip), or 0 (wgmma; -1: with fp32 out)
template <int MT, bool INT4>
__device__ __forceinline__ void body(const Launch& lp) {
  if constexpr (MT <= 0)
    tc_body<INT4, MT < 0>(lp);
  else if (!INT4 || lp.p.gs % 16 == 0)
    strip_run<MT, INT4, true>(lp.p);
  else
    strip_run<MT, INT4, false>(lp.p);
}

// Resident blocks a SM the compiler plans registers for.
constexpr int min_blocks(int mt) {
  return mt == 8 ? STRIP_MIN_BLOCKS : mt == 16 ? 2 : 1;
}

// One kernel per Pallas kernel; a 2-D weight is a stack of one layer.
template <int MT>
__global__ void __launch_bounds__(MT > 0 ? STRIP_THREADS : TC_THREADS,
                                      min_blocks(MT))
    qdot_kernel(const __grid_constant__ Launch lp) {
  body<MT, false>(lp);
}
template <int MT>
__global__ void __launch_bounds__(MT > 0 ? STRIP_THREADS : TC_THREADS,
                                      min_blocks(MT))
    qdot_stacked_kernel(const __grid_constant__ Launch lp) {
  body<MT, false>(lp);
}
template <int MT>
__global__ void __launch_bounds__(MT > 0 ? STRIP_THREADS : TC_THREADS,
                                      min_blocks(MT))
    q4dot_kernel(const __grid_constant__ Launch lp) {
  body<MT, true>(lp);
}
template <int MT>
__global__ void __launch_bounds__(MT > 0 ? STRIP_THREADS : TC_THREADS,
                                      min_blocks(MT))
    q4dot_stacked_kernel(const __grid_constant__ Launch lp) {
  body<MT, true>(lp);
}

// ------------------------------------------------------------------ host

// What the kernels take, and a plan that covers the depth (the wrapper's
// launch_plan computes it; this is the C side's own check).
bool valid(const QdotParams& p, bool int4, int body, int mt) {
  if (p.M <= 0 || p.D <= 0 || p.n_out <= 0 || p.n_out > p.Npad) return false;
  if (p.Npad % 128 != 0 || p.L <= 0 || p.li < 0 || p.li >= p.L) return false;
  if (int4 && (p.D % 2 != 0 || p.gs <= 0 || (p.D / 2) % p.gs != 0))
    return false;
  if (body == 1) return p.splits == 1;  // the wgmma body walks the depth
  if (body != 0 || (mt != 8 && mt != 16) || p.M > mt) return false;
  if (p.bn != 32 && p.bn != 64 && p.bn != 128) return false;
  if (p.splits < 1 || p.split_rows < 1 ||
      p.split_rows > (int4 ? STRIP_ROWS / 2 : STRIP_ROWS))
    return false;
  if (static_cast<long long>(p.splits - 1) * p.split_rows >= p.K ||
      static_cast<long long>(p.splits) * p.split_rows < p.K)
    return false;
  if (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr ||
                       (int4 && p.split_rows % p.gs != 0)))
    return false;
  return true;
}

// The codes' tensor map of a stack, encoded once per (address, shape).
cudaError_t weight_map(CUtensorMap* map, const QdotParams& p) {
  struct Entry {
    const void* w;
    int K, Npad, L;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.w == p.w && e.K == p.K && e.Npad == p.Npad && e.L == p.L) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  if ((reinterpret_cast<uintptr_t>(p.w) & 15) != 0)
    return cudaErrorInvalidValue;
  Entry e{p.w, p.K, p.Npad, p.L, {}};
  const cudaError_t err = tc::tiled_map(
      &e.map, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.w, p.Npad, p.K, p.L, p.Npad,
      static_cast<long long>(p.K) * p.Npad, TC_BN, TC_BK);
  if (err != cudaSuccess) return err;
  const int slot = used < 64 ? used++ : (next++ % 64);
  cache[slot] = e;
  *map = e.map;
  return cudaSuccess;
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, raised once per kernel
cudaError_t allow_smem(const void* fn, size_t bytes) {
  static std::mutex mu;
  static const void* fns[64];
  static size_t granted[64];
  static int n = 0;
  if (bytes <= 48 * 1024) return cudaSuccess;
  std::lock_guard<std::mutex> lock(mu);
  int i = 0;
  while (i < n && fns[i] != fn) ++i;
  if (i < n && granted[i] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (i == n && n < 64) fns[n++] = fn;
  if (i < 64) granted[i] = bytes;
  return cudaSuccess;
}

using Kernel = void (*)(const Launch);

template <bool INT4>
int launch(QdotParams p, int body, int mt, void* stream, Kernel k8,
           Kernel k16, Kernel k0, Kernel kp) {
  p.K = INT4 ? p.D / 2 : p.D;
  if (!valid(p, INT4, body, mt)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Launch lp{};
  lp.p = p;
  cudaError_t err;
  if (body == 0) {
    const Kernel k = mt == 8 ? k8 : k16;
    const size_t smem = strip_smem<INT4>(p.M, p.split_rows);
    err = allow_smem(reinterpret_cast<const void*>(k), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k<<<dim3(p.Npad / p.bn, p.splits), STRIP_THREADS, smem, s>>>(lp);
    return static_cast<int>(cudaGetLastError());
  }
  err = weight_map(&lp.wmap, p);
  lp.x_tma = p.x_bf16 && p.D % (INT4 ? 16 : 8) == 0 &&
             (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
  if (err == cudaSuccess && lp.x_tma)
    err = tc::tiled_map(&lp.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.D,
                        p.M, 1, 2LL * p.D, 2LL * p.D * p.M, TC_BK, TC_BM);
  // fp32 out: the kernel that carries the tensor cores' sums over
  const Kernel kernel = p.out_bf16 ? k0 : kp;
  if (err == cudaSuccess)
    err = allow_smem(reinterpret_cast<const void*>(kernel),
                     TcSmem<INT4>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((p.M + TC_BM - 1) / TC_BM, p.Npad / TC_BN), TC_THREADS,
           TcSmem<INT4>::BYTES, s>>>(lp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per kernel. body 0 (strip:
// mt rows of x, bn columns a block, splits of split_rows code rows; ws and
// counters when splits > 1) or 1 (wgmma). Return a cudaError_t: 0 when the
// launch was accepted.
extern "C" int v2pe_qdot(const void* x, const void* q, const float* scale,
                         void* out, float* ws, int* counters, int M, int D,
                         int Npad, int n_out, int x_bf16, int out_bf16,
                         int body, int mt, int bn, int splits, int split_rows,
                         void* stream) {
  const QdotParams p{x,  static_cast<const int8_t*>(q), scale, out, ws,
                     counters, 0, 1, M, D, 0, Npad, n_out, 0, x_bf16,
                     out_bf16, bn, splits, split_rows};
  return launch<false>(p, body, mt, stream, qdot_kernel<8>, qdot_kernel<16>,
                       qdot_kernel<0>, qdot_kernel<-1>);
}

extern "C" int v2pe_qdot_stacked(const void* x, const void* q,
                                 const float* scale, void* out, float* ws,
                                 int* counters, int li, int L, int M, int D,
                                 int Npad, int n_out, int x_bf16, int out_bf16,
                                 int body, int mt, int bn, int splits,
                                 int split_rows, void* stream) {
  const QdotParams p{x,  static_cast<const int8_t*>(q), scale, out, ws,
                     counters, li, L, M, D, 0, Npad, n_out, 0, x_bf16,
                     out_bf16, bn, splits, split_rows};
  return launch<false>(p, body, mt, stream, qdot_stacked_kernel<8>,
                       qdot_stacked_kernel<16>, qdot_stacked_kernel<0>, qdot_stacked_kernel<-1>);
}

extern "C" int v2pe_q4dot(const void* x, const void* packed,
                          const float* scale, void* out, float* ws,
                          int* counters, int M, int D, int Npad, int n_out,
                          int gs, int x_bf16, int out_bf16, int body, int mt,
                          int bn, int splits, int split_rows, void* stream) {
  const QdotParams p{x,  static_cast<const int8_t*>(packed), scale, out, ws,
                     counters, 0, 1, M, D, 0, Npad, n_out, gs, x_bf16,
                     out_bf16, bn, splits, split_rows};
  return launch<true>(p, body, mt, stream, q4dot_kernel<8>, q4dot_kernel<16>,
                      q4dot_kernel<0>, q4dot_kernel<-1>);
}

extern "C" int v2pe_q4dot_stacked(const void* x, const void* packed,
                                  const float* scale, void* out, float* ws,
                                  int* counters, int li, int L, int M, int D,
                                  int Npad, int n_out, int gs, int x_bf16,
                                  int out_bf16, int body, int mt, int bn,
                                  int splits, int split_rows, void* stream) {
  const QdotParams p{x,  static_cast<const int8_t*>(packed), scale, out, ws,
                     counters, li, L, M, D, 0, Npad, n_out, gs, x_bf16,
                     out_bf16, bn, splits, split_rows};
  return launch<true>(p, body, mt, stream, q4dot_stacked_kernel<8>,
                      q4dot_stacked_kernel<16>, q4dot_stacked_kernel<0>, q4dot_stacked_kernel<-1>);
}
