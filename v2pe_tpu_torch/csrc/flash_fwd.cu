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
// batch row itself. The tile update, what bounds it and the rotary are in
// flash_tile.cuh, which the fused ring forward (ring_fused_fwd.cu) shares.

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);

  const QSummary qs = load_q<T, D>(
      sm, static_cast<const T*>(p.q) + b * p.Sq * p.Hq * D,
      p.seg_q + b * p.Sq, p.pos_q + b * p.Sq,
      p.rope_q ? p.rope_q + b * p.Sq : nullptr, p.inv_freq, q0, p.Sq, p.Hq,
      h, p.scale);

  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.f;

  sweep_kv<T, D>(sm, qs, acc,
                 static_cast<const T*>(p.k) + b * p.Sk * p.Hkv * D,
                 static_cast<const T*>(p.v) + b * p.Sk * p.Hkv * D,
                 p.seg_k + b * p.Sk, p.pos_k + b * p.Sk,
                 p.rope_k ? p.rope_k + b * p.Sk : nullptr, p.inv_freq, p.Sk,
                 p.Hkv, hk, p.causal);

  write_out<T, D>(sm, acc, static_cast<T*>(p.out) + b * p.Sq * p.Hq * D,
                  p.lse + (b * p.Hq + h) * p.Sq, q0, p.Sq, p.Hq, h);
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
