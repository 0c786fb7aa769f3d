// Fused ring-attention forward for NVIDIA Hopper (sm_90a), fp32 or bf16.
//
// Replaces the Pallas TPU kernel v2pe_tpu/parallel/ring_fused.py:_kernel
// (wrapper _fused_fwd_impl). Same contract per rank of a ring of n ranks:
// the rank's queries (B,Sl,Hq,D) attend the K/V chunks (B,Sl,Hkv,D) of all
// n ranks in hop order (hop s brings the chunk of rank me - s), under the
// flash mask (equal nonzero segment ids and, if causal, pos_q >= pos_k on
// GLOBAL positions, so zigzag and contiguous layouts both work); q/k arrive
// rotated; out in the input dtype and lse fp32 are written once, with the
// flash contract (a row that attends nothing: out 0, lse -1e30).
//
// Design. One launch serves every rank whose shard lives on this card: a
// thread block owns one (rank, batch row, q head, 64-row query tile) and
// sweeps all n chunks itself, so the fp32 online-softmax state (m, l in
// shared memory, the accumulator in registers) stays on chip across the hops
// and nothing is merged through device memory, which is what the TPU kernel
// keeps in VMEM across its (hop, kv-block) grid axes. The tile update is
// flash_tile.cuh's, shared with flash_fwd.cu: per hop only the K/V base
// pointers change.
//
// Chunks are reached through a table of n base pointers per operand (k, v,
// segment ids, positions), read from device memory. The TPU kernel's slots,
// semaphores, startup barrier and drain move chunks between chips by remote
// DMA; here a block pulls a chunk's tiles through the table instead. With
// every shard on one card the entries point into one tensor; entries that
// point at a peer card's memory are all a multi-card ring changes.
//
// Under a causal zigzag layout half of all (query tile, hop) pairs are dead;
// sweep_kv skips a dead K/V tile from the min/max of its segment ids and
// positions before it loads k or v, so a dead hop costs its ids only.
//
// What bounds it: operations. The products are fp32 FMAs from shared memory
// (see flash_tile.cuh), far from the tensor cores' rate.

#include "flash_tile.cuh"

namespace {

struct RingParams {
  const void* q;       // (B, n * Sl, Hq, D): rank r's rows at [r Sl, (r+1) Sl)
  const int* seg_q;    // (B, n * Sl)
  const int* pos_q;    // (B, n * Sl)
  // (4, n) chunk base pointers: k, v (each chunk (B,Sl,Hkv,D) with batch
  // stride kv_batch_stride elements), segment ids, positions (each (B,Sl)
  // with batch stride vec_batch_stride)
  const long long* table;
  void* out;           // like q
  float* lse;          // (B, Hq, n * Sl)
  int B, n, Sl, Hq, Hkv;
  long long kv_batch_stride, vec_batch_stride;
  int causal;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) ring_fused_fwd_kernel(
    const RingParams p) {
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int r = blockIdx.z / p.B;
  const size_t b = blockIdx.z % p.B;
  const int hk = h / (p.Hq / p.Hkv);
  const size_t S = static_cast<size_t>(p.n) * p.Sl;
  const size_t row0 = b * S + static_cast<size_t>(r) * p.Sl;  // rank's rows

  const QSummary qs = load_q<T, D>(
      sm, static_cast<const T*>(p.q) + row0 * p.Hq * D, p.seg_q + row0,
      p.pos_q + row0, nullptr, nullptr, q0, p.Sl, p.Hq, h, p.scale);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  for (int s = 0; s < p.n; ++s) {
    const int c = (r - s + p.n) % p.n;  // hop s: the chunk of rank r - s
    const T* k = reinterpret_cast<const T*>(p.table[c]);
    const T* v = reinterpret_cast<const T*>(p.table[p.n + c]);
    const int* seg_k = reinterpret_cast<const int*>(p.table[2 * p.n + c]);
    const int* pos_k = reinterpret_cast<const int*>(p.table[3 * p.n + c]);
    sweep_kv<T, D>(sm, qs, acc, k + b * p.kv_batch_stride,
                   v + b * p.kv_batch_stride, seg_k + b * p.vec_batch_stride,
                   pos_k + b * p.vec_batch_stride, nullptr, nullptr, p.Sl,
                   p.Hkv, hk, p.causal);
  }

  write_out<T, D>(sm, acc, static_cast<T*>(p.out) + row0 * p.Hq * D,
                  p.lse + (b * p.Hq + h) * S + static_cast<size_t>(r) * p.Sl,
                  q0, p.Sl, p.Hq, h);
}

template <typename T, int D>
cudaError_t launch(const RingParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      ring_fused_fwd_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sl + BQ - 1) / BQ, p.Hq, p.n * p.B);
  ring_fused_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const RingParams& p, int is_bf16, cudaStream_t st) {
  return is_bf16 ? launch<__nv_bfloat16, D>(p, st) : launch<float, D>(p, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t: 0 when
// the launch was accepted.
extern "C" int v2pe_ring_fused_fwd(const void* q, const int* seg_q,
                                   const int* pos_q, const long long* table,
                                   void* out, float* lse, int B, int n, int Sl,
                                   int Hq, int Hkv, int D,
                                   long long kv_batch_stride,
                                   long long vec_batch_stride, int is_bf16,
                                   int causal, float scale, void* stream) {
  const RingParams p{q,  seg_q, pos_q, table,           out,
                     lse, B,    n,     Sl,              Hq,
                     Hkv, kv_batch_stride, vec_batch_stride, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch_dtype<16>(p, is_bf16, st));
    case 32: return static_cast<int>(launch_dtype<32>(p, is_bf16, st));
    case 64: return static_cast<int>(launch_dtype<64>(p, is_bf16, st));
    case 128: return static_cast<int>(launch_dtype<128>(p, is_bf16, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
