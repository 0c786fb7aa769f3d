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
// Design. One launch serves the ranks r0 .. r0 + nr - 1 of the ring: every
// rank when all shards live in one process's memory (q the global tensor),
// or the caller's rank alone when each rank is a process (q its own shard,
// the peers' chunks mapped into it by CUDA IPC). A
// thread block owns one (rank, batch row, q head, 64-row query tile) and
// sweeps all n chunks itself, so the fp32 online-softmax state stays on
// chip across the hops and nothing is merged through device memory, which
// is what the TPU kernel keeps in VMEM across its (hop, kv-block) grid
// axes. The tile is flash_tile.cuh's, shared with flash_fwd.cu: bf16 inputs
// run the tensor-core tile, whose producer warp walks the chunks of all
// hops in order and feeds their live K/V tiles through one TMA ring to the
// consumer warpgroup (its wgmma products and softmax state never see a hop
// boundary); fp32 inputs run the CUDA-core tile once per hop.
//
// Chunks are reached through a table of n base pointers per operand (k, v,
// segment ids, positions), read from device memory, and, for the bf16
// tile's TMA loads, through a tensor map of each chunk's k and v encoded on
// the host from the same addresses (kernel parameters: at most 8 ranks). The
// TPU kernel's slots, semaphores, startup barrier and drain move chunks
// between chips by remote DMA; here a block pulls a chunk's tiles itself.
// With every shard in one process the addresses point into one tensor;
// across processes they are the peers' buffers as mapped in the caller, and
// that, with the launched ranks, is all a ring of processes changes.

// Under a causal zigzag layout half of all (query tile, hop) pairs are dead;
// both tiles skip a dead K/V tile from the min/max of its segment ids and
// positions before they load k or v, so a dead hop costs its ids only.
//
// What bounds it: in bf16 the tensor cores' rate (see flash_tile.cuh for
// what the tile does and does not overlap); in fp32 the CUDA cores' FMAs
// from shared memory.

#include "flash_tile.cuh"

namespace {

struct RingParams {
  // the launched ranks r0 .. r0 + nr - 1: q, its ids, out and lse hold
  // their rows, rank r's at [(r - r0) Sl, (r - r0 + 1) Sl)
  const void* q;       // (B, nr * Sl, Hq, D)
  const int* seg_q;    // (B, nr * Sl)
  const int* pos_q;    // (B, nr * Sl)
  // (4, n) chunk base pointers: k, v (each chunk (B,Sl,Hkv,D) with batch
  // stride kv_batch_stride elements), segment ids, positions (each (B,Sl)
  // with batch stride vec_batch_stride)
  const long long* table;
  void* out;           // like q
  float* lse;          // (B, Hq, nr * Sl)
  int B, n, Sl, Hq, Hkv;
  int r0, nr;          // the first rank launched, the ranks launched
  long long kv_batch_stride, vec_batch_stride;
  int causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS) ring_fused_fwd_kernel(
    const RingParams p) {
  extern __shared__ float smem[];
  const Smem<D> sm(smem);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int r = p.r0 + static_cast<int>(blockIdx.z) / p.B;
  const size_t b = blockIdx.z % p.B;
  const int hk = h / (p.Hq / p.Hkv);
  const size_t S = static_cast<size_t>(p.nr) * p.Sl;  // q's rows a batch row
  const size_t row0 = b * S + static_cast<size_t>(r - p.r0) * p.Sl;

  const QSummary qs = load_q<D>(
      sm, static_cast<const float*>(p.q) + row0 * p.Hq * D, p.seg_q + row0,
      p.pos_q + row0, nullptr, nullptr, q0, p.Sl, p.Hq, h, p.scale);

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  for (int s = 0; s < p.n; ++s) {
    const int c = (r - s + p.n) % p.n;  // hop s: the chunk of rank r - s
    const float* k = reinterpret_cast<const float*>(p.table[c]);
    const float* v = reinterpret_cast<const float*>(p.table[p.n + c]);
    const int* seg_k = reinterpret_cast<const int*>(p.table[2 * p.n + c]);
    const int* pos_k = reinterpret_cast<const int*>(p.table[3 * p.n + c]);
    sweep_kv<D>(sm, qs, acc, k + b * p.kv_batch_stride,
                   v + b * p.kv_batch_stride, seg_k + b * p.vec_batch_stride,
                   pos_k + b * p.vec_batch_stride, nullptr, nullptr, p.Sl,
                   p.Hkv, hk, p.causal);
  }

  write_out<D>(sm, acc, static_cast<float*>(p.out) + row0 * p.Hq * D,
                  p.lse + (b * p.Hq + h) * S +
                      static_cast<size_t>(r - p.r0) * p.Sl,
                  q0, p.Sl, p.Hq, h);
}

// bf16: the tensor-core tile, with a tensor map of every chunk's k and v
// (each viewed as (Hkv*D, Sl, B) with the chunk's batch stride), as kernel
// parameters. Grid (Hq, n B, query tiles), the query tile counted down so
// that the heaviest causal tiles start first.
constexpr int MAX_TC_RANKS = 8;

struct RingTcParams {
  RingParams p;
  CUtensorMap kmap[MAX_TC_RANKS], vmap[MAX_TC_RANKS];
};

template <int D>
__global__ void __launch_bounds__(tc::THREADS, 2)
    ring_fused_fwd_tc_kernel(const __grid_constant__ RingTcParams tp) {
  const RingParams& p = tp.p;
  extern __shared__ uint8_t smem_raw[];
  const tc::Smem<D> sm(smem_raw);
  using bf16 = tc::bf16;
  const int h = blockIdx.x;
  const int r = p.r0 + static_cast<int>(blockIdx.y) / p.B;
  const size_t b = blockIdx.y % p.B;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * tc::BQ;
  const int hk = h / (p.Hq / p.Hkv);
  const size_t S = static_cast<size_t>(p.nr) * p.Sl;  // q's rows a batch row
  const size_t row0 = b * S + static_cast<size_t>(r - p.r0) * p.Sl;

  tc::setup<D>(sm, static_cast<const bf16*>(p.q) + row0 * p.Hq * D,
               p.seg_q + row0, p.pos_q + row0, nullptr, nullptr, q0, p.Sl,
               p.Hq, h);
  if (threadIdx.x >= tc::CONSUMERS) {
    const tc::QRange qr = tc::q_range<D>(sm, min(tc::BQ, p.Sl - q0));
    tc::Pipe pp;
    for (int s = 0; s < p.n; ++s) {
      const int c = (r - s + p.n) % p.n;  // hop s: the chunk of rank r - s
      const int* seg_k = reinterpret_cast<const int*>(p.table[2 * p.n + c]);
      const int* pos_k = reinterpret_cast<const int*>(p.table[3 * p.n + c]);
      tc::produce<D>(sm, pp, qr, &tp.kmap[c], &tp.vmap[c],
                     static_cast<int>(b), nullptr,
                     seg_k + b * p.vec_batch_stride,
                     pos_k + b * p.vec_batch_stride, nullptr, nullptr, p.Sl,
                     p.Hkv, hk, p.causal);
    }
    tc::finish<D>(sm, pp);
  } else {
    tc::Acc<D> acc;
    tc::consume<D>(sm, acc, p.scale, p.causal);
    tc::write_out<D>(acc, static_cast<bf16*>(p.out) + row0 * p.Hq * D,
                     p.lse + (b * p.Hq + h) * S +
                         static_cast<size_t>(r - p.r0) * p.Sl,
                     q0, p.Sl, p.Hq, h);
  }
}

template <int D>
cudaError_t launch_tc(const RingParams& p, const long long* k_chunks,
                      const long long* v_chunks, cudaStream_t stream) {
  constexpr size_t smem = tc::Smem<D>::BYTES;
  if (p.n > MAX_TC_RANKS || k_chunks == nullptr || v_chunks == nullptr)
    return cudaErrorInvalidValue;
  RingTcParams tp{};
  tp.p = p;
  const long long cols = static_cast<long long>(p.Hkv) * D;
  cudaError_t err = cudaSuccess;
  for (int c = 0; c < p.n && err == cudaSuccess; ++c) {
    err = tc::kv_map(&tp.kmap[c], reinterpret_cast<const void*>(k_chunks[c]),
                     cols, p.Sl, p.B, p.kv_batch_stride);
    if (err == cudaSuccess)
      err = tc::kv_map(&tp.vmap[c],
                       reinterpret_cast<const void*>(v_chunks[c]), cols, p.Sl,
                       p.B, p.kv_batch_stride);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ring_fused_fwd_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, p.nr * p.B, (p.Sl + tc::BQ - 1) / tc::BQ);
  ring_fused_fwd_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(tp);
  return cudaGetLastError();
}

// fp32: the CUDA-core tile, one sweep per hop.
template <int D>
cudaError_t launch(const RingParams& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      ring_fused_fwd_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sl + BQ - 1) / BQ, p.Hq, p.nr * p.B);
  ring_fused_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const RingParams& p, const long long* k_chunks,
                         const long long* v_chunks, int is_bf16,
                         cudaStream_t st) {
  return is_bf16 ? launch_tc<D>(p, k_chunks, v_chunks, st)
                 : launch<D>(p, st);
}

}  // namespace

// Plain C entry point (loaded with ctypes). k_chunks / v_chunks: host
// arrays of the n chunks' addresses (the table's first two rows, which the
// bf16 tile's tensor maps are encoded from; the fp32 tile reads the table).
// r0 / nr: the ranks launched (0 / n: all, q the global tensor).
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int v2pe_ring_fused_fwd(const void* q, const int* seg_q,
                                   const int* pos_q, const long long* table,
                                   const long long* k_chunks,
                                   const long long* v_chunks, void* out,
                                   float* lse, int B, int n, int Sl, int Hq,
                                   int Hkv, int D, long long kv_batch_stride,
                                   long long vec_batch_stride, int is_bf16,
                                   int causal, float scale, int r0, int nr,
                                   void* stream) {
  if (r0 < 0 || nr < 1 || r0 + nr > n)
    return static_cast<int>(cudaErrorInvalidValue);
  RingParams p{};
  p.q = q;
  p.seg_q = seg_q;
  p.pos_q = pos_q;
  p.table = table;
  p.out = out;
  p.lse = lse;
  p.B = B;
  p.n = n;
  p.Sl = Sl;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.r0 = r0;
  p.nr = nr;
  p.kv_batch_stride = kv_batch_stride;
  p.vec_batch_stride = vec_batch_stride;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dtype<16>(p, k_chunks, v_chunks, is_bf16, st);
    case 32: return launch_dtype<32>(p, k_chunks, v_chunks, is_bf16, st);
    case 64: return launch_dtype<64>(p, k_chunks, v_chunks, is_bf16, st);
    case 96: return launch_dtype<96>(p, k_chunks, v_chunks, is_bf16, st);
    case 128: return launch_dtype<128>(p, k_chunks, v_chunks, is_bf16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
