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
// (batch row, q head, 64-row q tile) and sweeps the 64-row K/V tiles of its
// batch row itself. bf16 inputs run the tensor-core tile (wgmma, K/V by TMA
// into a 2-stage mbarrier ring, a producer warp and a consumer warpgroup),
// launched heaviest query tile first; the tensor maps of k and v are
// encoded here on the host, per call (cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint, so no -lcuda). fp32 inputs run the fp32
// CUDA-core tile. Both tiles, what bounds each and the rotary are described
// in flash_tile.cuh, which the fused ring forward (ring_fused_fwd.cu)
// shares.

#include "flash_tile.cuh"

namespace {

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
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const QSummary qs = load_q<D>(
      sm, static_cast<const float*>(p.q) + b * p.Sq * p.Hq * D,
      p.seg_q + b * p.Sq, p.pos_q + b * p.Sq,
      p.rope_q ? p.rope_q + b * p.Sq : nullptr, p.inv_freq, q0, p.Sq, p.Hq,
      h, p.scale);

  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;

  sweep_kv<D>(sm, qs, acc,
                 static_cast<const float*>(p.k) + b * p.Sk * p.Hkv * D,
                 static_cast<const float*>(p.v) + b * p.Sk * p.Hkv * D,
                 p.seg_k + b * p.Sk, p.pos_k + b * p.Sk,
                 p.rope_k ? p.rope_k + b * p.Sk : nullptr, p.inv_freq, p.Sk,
                 p.Hkv, hk, p.causal);

  write_out<D>(sm, acc, static_cast<float*>(p.out) + b * p.Sq * p.Hq * D,
                  p.lse + (b * p.Hq + h) * p.Sq, q0, p.Sq, p.Hq, h);
}

// bf16: the tensor-core tile, with the tensor maps of k and v, each viewed
// as (Hkv*D, Sk, B). Grid (Hq, B, query tiles), the query tile counted down
// so that the heaviest causal tiles start first.
struct TcParams {
  Params p;
  CUtensorMap kmap, vmap;
};

template <int D>
__global__ void __launch_bounds__(tc::THREADS, 2)
    flash_fwd_tc_kernel(const __grid_constant__ TcParams tp) {
  const Params& p = tp.p;
  extern __shared__ uint8_t smem_raw[];
  const tc::Smem<D> sm(smem_raw);
  const int h = blockIdx.x;
  const size_t b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * tc::BQ;
  const int hk = h / (p.Hq / p.Hkv);
  using bf16 = tc::bf16;

  tc::setup<D>(sm, static_cast<const bf16*>(p.q) + b * p.Sq * p.Hq * D,
               p.seg_q + b * p.Sq, p.pos_q + b * p.Sq,
               p.rope_q ? p.rope_q + b * p.Sq : nullptr, p.inv_freq, q0,
               p.Sq, p.Hq, h);
  if (threadIdx.x >= tc::CONSUMERS) {
    const tc::QRange qr = tc::q_range<D>(sm, min(tc::BQ, p.Sq - q0));
    tc::Pipe pp;
    tc::produce<D>(sm, pp, qr, &tp.kmap, &tp.vmap, static_cast<int>(b),
                   static_cast<const bf16*>(p.k) + b * p.Sk * p.Hkv * D,
                   p.seg_k + b * p.Sk, p.pos_k + b * p.Sk,
                   p.rope_k ? p.rope_k + b * p.Sk : nullptr, p.inv_freq, p.Sk,
                   p.Hkv, hk, p.causal);
    tc::finish<D>(sm, pp);
  } else {
    tc::Acc<D> acc;
    tc::consume<D>(sm, acc, p.scale, p.causal);
    tc::write_out<D>(acc, static_cast<bf16*>(p.out) + b * p.Sq * p.Hq * D,
                     p.lse + (b * p.Hq + h) * p.Sq, q0, p.Sq, p.Hq, h);
  }
}

template <int D>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = tc::Smem<D>::BYTES;
  TcParams tp{p, {}, {}};
  const long long cols = static_cast<long long>(p.Hkv) * D;
  cudaError_t err = tc::kv_map(&tp.kmap, p.k, cols, p.Sk, p.B, p.Sk * cols);
  if (err == cudaSuccess)
    err = tc::kv_map(&tp.vmap, p.v, cols, p.Sk, p.B, p.Sk * cols);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, p.B, (p.Sq + tc::BQ - 1) / tc::BQ);
  flash_fwd_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(tp);
  return cudaGetLastError();
}

// fp32: the CUDA-core tile.
template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(p);
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
    err = is_bf16 ? launch_tc<64>(p, st) : launch<64>(p, st);
  } else if (D == 96) {
    err = is_bf16 ? launch_tc<96>(p, st) : launch<96>(p, st);
  } else if (D == 128) {
    err = is_bf16 ? launch_tc<128>(p, st) : launch<128>(p, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
