// Paged decode attention for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/attention_paged.py::paged_decode_attention
// (its pallas_call), both branches: a full-precision pool (kernel 7) and an
// int8 pool (quantized=True, kernel 7q) whose entries carry one f32 scale per
// (key, kv-head).  One decode token per slot attends over the K/V pages its
// block-table row names:
//
//   q [B, Hkv, G, dh], pool k/v [Pt, ps, Hkv, dh] (int8 with scales ks/vs
//   [Pt, ps, Hkv, 1] f32), kpos [Pt, ps] int32, table [B, nt] int32
//   (pre-clamped: -1 -> trash page Pt - 1), qpos [B] int32
//   -> out [B, Hkv, G, dh]
//
// with validity / causal / window masks from the pool's positions, softcap,
// f32 scores, softmax and accumulation, output in the input type (bfloat16
// on the serving path, or float).  The masking rules are paged_attention.cuh's.
//
// bf16 (the served path, kernels 7 and 7q): split-K on the tensor cores,
// paged_mma.cuh.
//   1. Grid (Hkv, B, splits): the block of split s compacts its row's live
//      entries (trash skipped) and takes the 64-key tiles of rank
//      [s * L / splits, (s + 1) * L / splits) of the L tiles they make, so
//      the splits of a row share its live pages equally however few they
//      are.  The G query heads of the kv-head are the rows (padded to one
//      16-row mma.sync fragment); tiles are double-buffered with cp.async (an
//      int8 pool lands as int8 and is widened in shared memory into one bf16
//      buffer).  Each of the 4 warps takes 16 keys of a tile with its own
//      online softmax; at the end the warps merge in shared memory and the
//      block writes f32 partials (m, l, the unnormalised accumulator per
//      query row) to a workspace the wrapper allocates, or at one split the
//      output itself.  A split with no valid key writes m = -1e30, l = 0,
//      acc = 0.
//   2. merge_splits, one thread per output value:
//        m* = max_s m_s,  out = sum_s acc_s e^(m_s - m*) / sum_s l_s e^(m_s - m*)
//      where a split with no valid key adds 0 and a row with none at all
//      gives 0.
// The number of splits comes from static shapes only (the wrapper's
// decode_splits: about two blocks per SM, at least one 64-key tile per
// split), so the call makes no host read of a device value and can be
// captured in a CUDA graph.
//
// f32 (reduced checks): unsplit, one block per (kv-head, slot) on CUDA
// cores, paged_attention.cuh's Attn.
//
// Bound: decode reads each live page's K and V once, ps * Hkv * dh values
// each, plus their positions, and does 4 * H * dh operations per unmasked
// (query, key) pair, about one per byte: far below the card's 295 operations
// per byte, so the least time is the live bytes over 3.35 TB/s (an int8 pool
// reads dh + 4 bytes per key and head, about half of bf16's 2 * dh).  What
// still holds it back: each block keeps one tile in flight beside the one it
// computes, so a block reads at one tile per memory latency; its prologue
// (compact, first load) is two dependent global reads; the splits follow
// the static shapes, so a trace with few active slots leaves most of the
// grid idle; and the second launch and the partials' round trip through L2
// cost a few microseconds that a short row does not amortise.
#include "paged_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 (fp or int8 pool): split-K on tensor cores, then the merge
// ---------------------------------------------------------------------------

using paged_mma::GR;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* kpos;
  const int* table;
  const int* qpos;
  void* out;
  float* ws;  // split-K partials (paged_mma::partial_m / _l / _acc), R = B * Hkv * G rows
  int B, Hkv, G, ps, nt, Pt;
  paged::Mask mk;
};

template <int DH, bool Q8>
__global__ void __launch_bounds__(paged_mma::NT) decode_split_kernel(const Params p) {
  using namespace paged_mma;
  constexpr int NB = Q8 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const Src src{p.k, p.v, p.ks, p.vs, p.kpos, p.table + (size_t)b * p.nt, nullptr, nullptr,
                nullptr, p.ps, p.Pt, p.Hkv, h, 0, INT_MAX};
  const size_t row0 = ((size_t)b * p.Hkv + h) * p.G;
  // every tile of a compacted row is live: no position scan, a mask per entry
  decode_block<DH, Q8, NB>(*reinterpret_cast<Smem<DH, Q8, NB>*>(smem_raw), src,
                           static_cast<const bf16*>(p.q) + row0 * DH, p.G, __ldg(p.qpos + b), p.mk,
                           false, p.nt, blockIdx.z, gridDim.z, static_cast<bf16*>(p.out), p.ws,
                           (size_t)p.B * p.Hkv * p.G, row0);
}

template <int DH, bool Q8>
int launch_split(const Params& p, int splits, cudaStream_t stream) {
  const int smem = (int)sizeof(paged_mma::Smem<DH, Q8, Q8 ? 1 : 2>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_split_kernel<DH, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  decode_split_kernel<DH, Q8><<<dim3(p.Hkv, p.B, splits), paged_mma::NT, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return paged_mma::launch_merge<DH>(p.ws, static_cast<bf16*>(p.out), p.B * p.Hkv * p.G, splits,
                                     stream);
}

template <bool Q8>
int dispatch_split(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                   const void* kpos, const void* table, const void* qpos, void* out, void* ws,
                   int B, int Hkv, int G, int dh, int ps, int nt, int Pt, int splits, float scale,
                   int causal, int window, float softcap, void* stream) {
  if (G < 1 || G > GR || ps < 1 || ps > paged::KT || B < 1 || Hkv < 1 || nt < 1 || splits < 1 ||
      splits > 65535)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(kpos), static_cast<const int*>(table),
                 static_cast<const int*>(qpos), out, static_cast<float*>(ws), B, Hkv, G, ps, nt,
                 Pt, paged::Mask{scale, softcap, causal, window}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_split<32, Q8>(p, splits, st);
    case 64: return launch_split<64, Q8>(p, splits, st);
    case 128: return launch_split<128, Q8>(p, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, the shared code of paged_attention.cuh
// ---------------------------------------------------------------------------

constexpr int F32_NT = 128;  // threads per block
constexpr int F32_RT = 16;   // query rows per block: G <= 16

template <int DH, typename KV>
__global__ void __launch_bounds__(F32_NT) decode_kernel(
    const float* __restrict__ q, const KV pool, const int* __restrict__ kpos,
    const int* __restrict__ table, const int* __restrict__ qpos, float* __restrict__ out, int Hkv,
    int G, int ps, int nt, int Pt, paged::Mask mk) {
  using A = paged::Attn<float, DH, F32_RT, F32_NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  A a(*reinterpret_cast<typename A::Smem*>(smem), mk);
  const int h = blockIdx.x, b = blockIdx.y;
  a.load_queries(q, qpos, Hkv, h, G, b * G, G);
  a.attend_pool(pool, kpos, table + (size_t)b * nt, nt, ps, Pt, Hkv, h, INT_MAX);
  a.store(out, Hkv, h, G, b * G);
}

template <int DH, typename KV>
int launch(const void* q, const KV& pool, const void* kpos, const void* table, const void* qpos,
           void* out, int B, int Hkv, int G, int ps, int nt, int Pt, const paged::Mask& mk,
           void* stream) {
  const int smem = (int)sizeof(typename paged::Attn<float, DH, F32_RT, F32_NT>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<DH, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  decode_kernel<DH, KV><<<dim3(Hkv, B), F32_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), pool, static_cast<const int*>(kpos),
      static_cast<const int*>(table), static_cast<const int*>(qpos), static_cast<float*>(out), Hkv,
      G, ps, nt, Pt, mk);
  return cudaGetLastError();
}

template <typename KV>
int dispatch(const void* q, const KV& pool, const void* kpos, const void* table, const void* qpos,
             void* out, int B, int Hkv, int G, int dh, int ps, int nt, int Pt, float scale,
             int causal, int window, float softcap, void* stream) {
  if (G < 1 || G > F32_RT || ps < 1 || ps > paged::KT || B < 1 || Hkv < 1 || nt < 1)
    return cudaErrorInvalidValue;
  const paged::Mask mk{scale, softcap, causal, window};
  switch (dh) {
    case 32: return launch<32>(q, pool, kpos, table, qpos, out, B, Hkv, G, ps, nt, Pt, mk, stream);
    case 64: return launch<64>(q, pool, kpos, table, qpos, out, B, Hkv, G, ps, nt, Pt, mk, stream);
    case 128: return launch<128>(q, pool, kpos, table, qpos, out, B, Hkv, G, ps, nt, Pt, mk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, out (and the bf16
// entries' workspace ws of splits * B * Hkv * G * (dh + 2) floats, unused at
// one split) allocated by the caller, stream a cudaStream_t; returns
// cudaGetLastError() (0 = success).
extern "C" int paged_decode_attention_bf16(const void* q, const void* k, const void* v,
                                           const void* kpos, const void* table, const void* qpos,
                                           void* out, void* ws, int B, int Hkv, int G, int dh,
                                           int ps, int nt, int Pt, int splits, float scale,
                                           int causal, int window, float softcap, void* stream) {
  return dispatch_split<false>(q, k, nullptr, v, nullptr, kpos, table, qpos, out, ws, B, Hkv, G,
                               dh, ps, nt, Pt, splits, scale, causal, window, softcap, stream);
}

extern "C" int paged_decode_attention_f32(const void* q, const void* k, const void* v,
                                          const void* kpos, const void* table, const void* qpos,
                                          void* out, int B, int Hkv, int G, int dh, int ps, int nt,
                                          int Pt, float scale, int causal, int window,
                                          float softcap, void* stream) {
  return dispatch(q, paged::kv_fp<float>(k, v), kpos, table, qpos, out, B, Hkv, G, dh, ps, nt, Pt,
                  scale, causal, window, softcap, stream);
}

// Kernel 7q, the int8 pool: k/v int8 [Pt, ps, Hkv, dh], ks/vs f32 [Pt, ps, Hkv, 1].
extern "C" int paged_decode_attention_int8_bf16(const void* q, const void* k, const void* ks,
                                                const void* v, const void* vs, const void* kpos,
                                                const void* table, const void* qpos, void* out,
                                                void* ws, int B, int Hkv, int G, int dh, int ps,
                                                int nt, int Pt, int splits, float scale,
                                                int causal, int window, float softcap,
                                                void* stream) {
  return dispatch_split<true>(q, k, ks, v, vs, kpos, table, qpos, out, ws, B, Hkv, G, dh, ps, nt,
                              Pt, splits, scale, causal, window, softcap, stream);
}

extern "C" int paged_decode_attention_int8_f32(const void* q, const void* k, const void* ks,
                                               const void* v, const void* vs, const void* kpos,
                                               const void* table, const void* qpos, void* out,
                                               int B, int Hkv, int G, int dh, int ps, int nt,
                                               int Pt, float scale, int causal, int window,
                                               float softcap, void* stream) {
  return dispatch(q, paged::kv_q8(k, ks, v, vs), kpos, table, qpos, out, B, Hkv, G, dh, ps, nt,
                  Pt, scale, causal, window, softcap, stream);
}
