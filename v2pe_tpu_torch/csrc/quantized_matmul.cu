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
// dequantized as bf16(nibble * scale) and out = bf16(x) . w. x (M, D) is
// bf16 or fp32 and is rounded to bf16 either way; products accumulate in
// fp32; out (M, n_out) is fp32 or bf16, and only n_out of the Npad columns
// are written. The stacked kernels take the whole stack and a layer index
// and read that layer in place, as the Pallas index maps do.
//
// Design. The TPU kernels hand (bm, D) x (D, bn) blocks in VMEM to the
// matrix unit; the block sizes there are VMEM budgets and do not carry over.
// Here each kernel has two bodies, chosen by M at launch:
// - M <= 16 (decode, the vocab head): a block of 256 threads owns a strip of
//   32 output columns and streams the strip's weights once. A thread reads 4
//   neighbouring codes of one row (8 threads cover a 32-byte sector, a warp 4
//   rows), so a sweep of the block covers 32 rows; x is staged in shared
//   memory 512 (int4: 2 x 256) contracted rows at a time, already rounded to
//   bf16. Partial sums meet through warp shuffles and one pass over shared
//   memory. Rows of x are padded to 4 or 16 in registers only. (16 codes a
//   thread in one 16-byte load was tried: its 64 sums and 32 scales took
//   ~130 registers, one block a SM, and the head and every int4 form got
//   slower; only the narrow w2 gained.)
// - M > 16 (prefill): a 64 x 64 output tile per block, 16 contracted rows a
//   step; x and the dequantized weights are staged as fp32 in shared memory
//   and each thread keeps a 4 x 4 tile of fp32 sums. The int4 body walks the
//   full depth D and picks the nibble by the half a row lies in, so the
//   packed bytes are read once per half.
//
// What bounds them. At M <= 16 every weight byte is read once for 2*M
// operations: device memory bounds it, and with one strip per block the
// narrow products (N = 2048: 64 blocks on 132 SMs) by how few loads are in
// flight; a split of D over blocks is a later change. At large M the fp32
// FMA loop from shared memory is bound by the CUDA cores; bf16 tensor-core
// products (mma.sync / wgmma) with the dequantize in registers are a later
// change.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct QdotParams {
  const void* x;       // (M, D) bf16 or fp32
  const int8_t* w;     // int8 codes (L, D, Npad) or packed nibbles (L, D/2, Npad)
  const float* scale;  // (L, 1, Npad) or (L, D/gs, Npad)
  void* out;           // (M, n_out) fp32 or bf16
  int M, D, Npad, n_out;
  int gs;  // int4: contracted rows per scale group
  int x_bf16, out_bf16;
};

// x[i] rounded to bf16, as fp32
__device__ __forceinline__ float load_x(const QdotParams& p, size_t i) {
  if (p.x_bf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p.x)[i]);
  return __bfloat162float(
      __float2bfloat16_rn(static_cast<const float*>(p.x)[i]));
}

__device__ __forceinline__ void store_out(const QdotParams& p, size_t i,
                                          float v) {
  if (p.out_bf16)
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p.out)[i] = v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the low nibble sign-extended, and the high one by an arithmetic shift
__device__ __forceinline__ int nibble_lo(int b) {
  return static_cast<int>(static_cast<unsigned>(b) << 28) >> 28;
}
__device__ __forceinline__ int nibble_hi(int b) { return b >> 4; }

__device__ __forceinline__ void unpack(char4 c, int* b) {
  b[0] = c.x, b[1] = c.y, b[2] = c.z, b[3] = c.w;
}
__device__ __forceinline__ void unpack(float4 f, float* s) {
  s[0] = f.x, s[1] = f.y, s[2] = f.z, s[3] = f.w;
}

// ------------------------------------------------------------ M <= 16

constexpr int SM_THREADS = 256;
constexpr int SM_COLS = 32;  // output columns per block: one 32-byte sector

constexpr int CPT = 4;        // neighbouring columns a thread owns
constexpr int LPR = SM_COLS / CPT;             // lanes that share a row
constexpr int SWEEP = (SM_THREADS / 32) * (32 / LPR);  // rows a sweep: 32

// w and scale point at the layer to read.
template <int MT, bool INT4>
__device__ void small_m_body(const QdotParams& p, const int8_t* w,
                             const float* scale) {
  constexpr int H = INT4 ? 2 : 1;         // halves of x a byte row meets
  constexpr int DC = INT4 ? 256 : 512;    // byte rows staged at a time
  __shared__ float x_s[H * MT * DC];      // [half][m][row]
  const int K = INT4 ? p.D / 2 : p.D;     // byte rows
  const int G2 = INT4 ? p.D / p.gs / 2 : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane % LPR, rsub = lane / LPR;
  const int r0 = warp * (32 / LPR) + rsub;  // this thread's row of a sweep
  const int col = blockIdx.x * SM_COLS + cg * CPT;

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

  for (int c0 = 0; c0 < K; c0 += DC) {
    const int nrow = min(DC, K - c0);
    for (int idx = tid; idx < H * MT * DC; idx += SM_THREADS) {
      const int d = idx % DC, m = (idx / DC) % MT, h = idx / (DC * MT);
      float v = 0.f;
      if (m < p.M && d < nrow)
        v = load_x(p, static_cast<size_t>(m) * p.D + h * K + c0 + d);
      x_s[idx] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = r0; d < nrow; d += SWEEP) {
      const size_t row = static_cast<size_t>(c0 + d);
      int b[CPT];
      unpack(*reinterpret_cast<const char4*>(w + row * p.Npad + col), b);
      float wl[CPT], wh[CPT];
      if (INT4) {
        const int g = (c0 + d) / p.gs;
        float sl[CPT], sh[CPT];
        unpack(*reinterpret_cast<const float4*>(
                   scale + static_cast<size_t>(g) * p.Npad + col), sl);
        unpack(*reinterpret_cast<const float4*>(
                   scale + static_cast<size_t>(g + G2) * p.Npad + col), sh);
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          wl[j] = bf16_round(static_cast<float>(nibble_lo(b[j])) * sl[j]);
          wh[j] = bf16_round(static_cast<float>(nibble_hi(b[j])) * sh[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < CPT; ++j) wl[j] = static_cast<float>(b[j]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xl = x_s[m * DC + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[m][j] = fmaf(xl, wl[j], acc[m][j]);
        if (INT4) {
          const float xh = x_s[(MT + m) * DC + d];
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[m][j] = fmaf(xh, wh[j], acc[m][j]);
        }
      }
    }
    __syncthreads();
  }

  // the row lanes of a warp that share a column group, then the 8 warps
  float* red = x_s;  // [warp][m][column of the strip]
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (rsub == 0) red[(warp * MT + m) * SM_COLS + cg * CPT + j] = v;
    }
  __syncthreads();
  for (int idx = tid; idx < MT * SM_COLS; idx += SM_THREADS) {
    const int m = idx / SM_COLS, c = idx % SM_COLS;
    const int n = blockIdx.x * SM_COLS + c;
    if (m >= p.M || n >= p.n_out) continue;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < SM_THREADS / 32; ++wi)
      v += red[(wi * MT + m) * SM_COLS + c];
    if (!INT4) v *= scale[n];
    store_out(p, static_cast<size_t>(m) * p.n_out + n, v);
  }
}

// ------------------------------------------------------------- M > 16

constexpr int BM = 64, BN = 64, BKT = 16;
constexpr int T_THREADS = 256;

template <bool INT4>
__device__ void tiled_body(const QdotParams& p, const int8_t* w,
                           const float* scale) {
  __shared__ __align__(16) float xs[BKT][BM + 4];  // [k][m]
  __shared__ __align__(16) float ws[BKT][BN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int D2 = p.D / 2;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.D; k0 += BKT) {
    for (int idx = tid; idx < BM * BKT; idx += T_THREADS) {
      const int m = idx / BKT, k = idx % BKT;
      float v = 0.f;
      if (m0 + m < p.M && k0 + k < p.D)
        v = load_x(p, static_cast<size_t>(m0 + m) * p.D + k0 + k);
      xs[k][m] = v;
    }
    {  // 16 rows x 64 columns of weights, 4 columns a thread
      const int k = tid / 16, c = (tid % 16) * 4, kk = k0 + k;
      float wv[4] = {0.f, 0.f, 0.f, 0.f};
      if (kk < p.D) {
        const int hi = INT4 && kk >= D2;
        const size_t row = static_cast<size_t>(hi ? kk - D2 : kk);
        int b[4];
        unpack(*reinterpret_cast<const char4*>(w + row * p.Npad + n0 + c), b);
        if (INT4) {
          float s[4];
          unpack(*reinterpret_cast<const float4*>(
                     scale + static_cast<size_t>(kk / p.gs) * p.Npad + n0 + c),
                 s);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = bf16_round(static_cast<float>(hi ? nibble_hi(b[j])
                                                     : nibble_lo(b[j])) *
                               s[j]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = static_cast<float>(b[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) ws[k][c + j] = wv[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BKT; ++k) {
      float a[4], b[4];
      unpack(*reinterpret_cast<const float4*>(&xs[k][ty * 4]), a);
      unpack(*reinterpret_cast<const float4*>(&ws[k][tx * 4]), b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= p.n_out) continue;
      const float v = INT4 ? acc[i][j] : acc[i][j] * scale[n];
      store_out(p, static_cast<size_t>(m) * p.n_out + n, v);
    }
  }
}

template <int MT, bool INT4>
__device__ __forceinline__ void body(const QdotParams& p, const int8_t* w,
                                     const float* scale) {
  if constexpr (MT > 0)
    small_m_body<MT, INT4>(p, w, scale);
  else
    tiled_body<INT4>(p, w, scale);
}

// One kernel per Pallas kernel; MT = 4 or 16 rows of x, or 0 for the tiled
// body. The stacked ones step to layer li of the stack themselves.

template <int MT>
__global__ void __launch_bounds__(256) qdot_kernel(QdotParams p) {
  body<MT, false>(p, p.w, p.scale);
}

template <int MT>
__global__ void __launch_bounds__(256) qdot_stacked_kernel(QdotParams p,
                                                           int li) {
  body<MT, false>(p, p.w + static_cast<size_t>(li) * p.D * p.Npad,
                  p.scale + static_cast<size_t>(li) * p.Npad);
}

template <int MT>
__global__ void __launch_bounds__(256) q4dot_kernel(QdotParams p) {
  body<MT, true>(p, p.w, p.scale);
}

template <int MT>
__global__ void __launch_bounds__(256) q4dot_stacked_kernel(QdotParams p,
                                                            int li) {
  body<MT, true>(p, p.w + static_cast<size_t>(li) * (p.D / 2) * p.Npad,
                 p.scale + static_cast<size_t>(li) * (p.D / p.gs) * p.Npad);
}

bool valid(const QdotParams& p, bool int4) {
  if (p.M <= 0 || p.D <= 0 || p.n_out <= 0 || p.n_out > p.Npad) return false;
  if (p.Npad % 128 != 0) return false;
  if (int4 && (p.D % 2 != 0 || p.gs <= 0 || (p.D / 2) % p.gs != 0))
    return false;
  return true;
}

// Launch KERNEL<MT> with the body that fits p.M; evaluates to the launch's
// cudaError_t.
#define V2PE_QDOT_LAUNCH(KERNEL, INT4, ...)                                  \
  [&]() -> int {                                                             \
    if (!valid(p, INT4)) return static_cast<int>(cudaErrorInvalidValue);     \
    const cudaStream_t s = static_cast<cudaStream_t>(stream);                \
    if (p.M <= 4)                                                            \
      KERNEL<4><<<p.Npad / SM_COLS, SM_THREADS, 0, s>>>(__VA_ARGS__);        \
    else if (p.M <= 16)                                                      \
      KERNEL<16><<<p.Npad / SM_COLS, SM_THREADS, 0, s>>>(__VA_ARGS__);       \
    else                                                                     \
      KERNEL<0><<<dim3(p.Npad / BN, (p.M + BM - 1) / BM), T_THREADS, 0, s>>>( \
          __VA_ARGS__);                                                      \
    return static_cast<int>(cudaGetLastError());                             \
  }()

}  // namespace

extern "C" int v2pe_qdot(const void* x, const void* q, const float* scale,
                         void* out, int M, int D, int Npad, int n_out,
                         int x_bf16, int out_bf16, void* stream) {
  const QdotParams p{x, static_cast<const int8_t*>(q), scale, out, M, D,
                     Npad, n_out, 0, x_bf16, out_bf16};
  return V2PE_QDOT_LAUNCH(qdot_kernel, false, p);
}

extern "C" int v2pe_qdot_stacked(const void* x, const void* q,
                                 const float* scale, void* out, int li, int M,
                                 int D, int Npad, int n_out, int x_bf16,
                                 int out_bf16, void* stream) {
  const QdotParams p{x, static_cast<const int8_t*>(q), scale, out, M, D,
                     Npad, n_out, 0, x_bf16, out_bf16};
  return V2PE_QDOT_LAUNCH(qdot_stacked_kernel, false, p, li);
}

extern "C" int v2pe_q4dot(const void* x, const void* packed,
                          const float* scale, void* out, int M, int D,
                          int Npad, int n_out, int gs, int x_bf16,
                          int out_bf16, void* stream) {
  const QdotParams p{x, static_cast<const int8_t*>(packed), scale, out, M, D,
                     Npad, n_out, gs, x_bf16, out_bf16};
  return V2PE_QDOT_LAUNCH(q4dot_kernel, true, p);
}

extern "C" int v2pe_q4dot_stacked(const void* x, const void* packed,
                                  const float* scale, void* out, int li, int M,
                                  int D, int Npad, int n_out, int gs,
                                  int x_bf16, int out_bf16, void* stream) {
  const QdotParams p{x, static_cast<const int8_t*>(packed), scale, out, M, D,
                     Npad, n_out, gs, x_bf16, out_bf16};
  return V2PE_QDOT_LAUNCH(q4dot_stacked_kernel, true, p, li);
}
