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
// on the serving path, or float).  int8 pages are widened and scaled in f32
// while they are staged, as the TPU kernel dequantizes in VMEM.  The shared
// device code and the masking rules are in paged_attention.cuh.
//
// One block per (kv-head, slot), 128 threads: the G query heads of a kv-head
// share every K/V page the block stages, as the TPU kernel's (b, h) grid
// cell does.  Trash entries are skipped without a read; live pages are staged
// two at a time (32 keys at page size 16).
//
// Bound: decode reads each live page's K and V once, ps * Hkv * dh values
// each, plus their positions, and does 4 * H * dh operations per unmasked
// (query, key) pair, about one per byte: far below the card's 295 operations
// per byte, so the least time is the live bytes over 3.35 TB/s (an int8 pool
// reads dh + 4 bytes per key and head, about half of bf16's 2 * dh).  This
// kernel does not reach it: B * Hkv blocks (64 at B = 8) fill half the card's
// 132 SMs, and each block walks its pages one tile at a time with a barrier
// between loading and using a tile.  Splitting a row's pages over several
// blocks (split-K) and keeping loads in flight (cp.async or TMA) are later
// work.
#include "paged_attention.cuh"

namespace {

constexpr int NT = 128;  // threads per block
constexpr int RT = 16;   // query rows per block: G <= 16

template <typename T, int DH, typename KV>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const KV pool, const int* __restrict__ kpos,
    const int* __restrict__ table, const int* __restrict__ qpos, T* __restrict__ out, int Hkv,
    int G, int ps, int nt, int Pt, paged::Mask mk) {
  using A = paged::Attn<T, DH, RT, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  A a(*reinterpret_cast<typename A::Smem*>(smem), mk);
  const int h = blockIdx.x, b = blockIdx.y;
  a.load_queries(q, qpos, Hkv, h, G, b * G, G);
  a.attend_pool(pool, kpos, table + (size_t)b * nt, nt, ps, Pt, Hkv, h, INT_MAX);
  a.store(out, Hkv, h, G, b * G);
}

template <typename T, int DH, typename KV>
int launch(const void* q, const KV& pool, const void* kpos, const void* table, const void* qpos,
           void* out, int B, int Hkv, int G, int ps, int nt, int Pt, const paged::Mask& mk,
           void* stream) {
  const int smem = (int)sizeof(typename paged::Attn<T, DH, RT, NT>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<T, DH, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  decode_kernel<T, DH, KV><<<dim3(Hkv, B), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), pool, static_cast<const int*>(kpos),
      static_cast<const int*>(table), static_cast<const int*>(qpos), static_cast<T*>(out), Hkv, G,
      ps, nt, Pt, mk);
  return cudaGetLastError();
}

template <typename T, typename KV>
int dispatch(const void* q, const KV& pool, const void* kpos, const void* table, const void* qpos,
             void* out, int B, int Hkv, int G, int dh, int ps, int nt, int Pt, float scale,
             int causal, int window, float softcap, void* stream) {
  if (G < 1 || G > RT || ps < 1 || ps > paged::KT || B < 1 || Hkv < 1 || nt < 1)
    return cudaErrorInvalidValue;
  const paged::Mask mk{scale, softcap, causal, window};
  switch (dh) {
    case 32: return launch<T, 32>(q, pool, kpos, table, qpos, out, B, Hkv, G, ps, nt, Pt, mk, stream);
    case 64: return launch<T, 64>(q, pool, kpos, table, qpos, out, B, Hkv, G, ps, nt, Pt, mk, stream);
    case 128: return launch<T, 128>(q, pool, kpos, table, qpos, out, B, Hkv, G, ps, nt, Pt, mk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_decode_attention_bf16(const void* q, const void* k, const void* v,
                                           const void* kpos, const void* table, const void* qpos,
                                           void* out, int B, int Hkv, int G, int dh, int ps, int nt,
                                           int Pt, float scale, int causal, int window,
                                           float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, paged::kv_fp<__nv_bfloat16>(k, v), kpos, table, qpos, out, B,
                                 Hkv, G, dh, ps, nt, Pt, scale, causal, window, softcap, stream);
}

extern "C" int paged_decode_attention_f32(const void* q, const void* k, const void* v,
                                          const void* kpos, const void* table, const void* qpos,
                                          void* out, int B, int Hkv, int G, int dh, int ps, int nt,
                                          int Pt, float scale, int causal, int window,
                                          float softcap, void* stream) {
  return dispatch<float>(q, paged::kv_fp<float>(k, v), kpos, table, qpos, out, B, Hkv, G, dh, ps,
                         nt, Pt, scale, causal, window, softcap, stream);
}

// Kernel 7q, the int8 pool: k/v int8 [Pt, ps, Hkv, dh], ks/vs f32 [Pt, ps, Hkv, 1].
extern "C" int paged_decode_attention_int8_bf16(const void* q, const void* k, const void* ks,
                                                const void* v, const void* vs, const void* kpos,
                                                const void* table, const void* qpos, void* out,
                                                int B, int Hkv, int G, int dh, int ps, int nt,
                                                int Pt, float scale, int causal, int window,
                                                float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, paged::kv_q8(k, ks, v, vs), kpos, table, qpos, out, B, Hkv, G,
                                 dh, ps, nt, Pt, scale, causal, window, softcap, stream);
}

extern "C" int paged_decode_attention_int8_f32(const void* q, const void* k, const void* ks,
                                               const void* v, const void* vs, const void* kpos,
                                               const void* table, const void* qpos, void* out,
                                               int B, int Hkv, int G, int dh, int ps, int nt,
                                               int Pt, float scale, int causal, int window,
                                               float softcap, void* stream) {
  return dispatch<float>(q, paged::kv_q8(k, ks, v, vs), kpos, table, qpos, out, B, Hkv, G, dh, ps,
                         nt, Pt, scale, causal, window, softcap, stream);
}
