// Paged chunk-prefill attention for Hopper, sm_90a.
//
// Replaces the TPU kernel
// repro/kernels/attention_prefill_paged.py::paged_prefill_attention (its
// pallas_call), both branches: a full-precision pool (kernel 8) and an int8
// pool with one f32 scale per (key, kv-head) (quantized=True, kernel 8q).
// A chunk of C prompt tokens of one sequence attends over
//
//   1. the pages its block-table row names (earlier chunks), with pool keys
//      at positions >= the chunk start qpos[0] masked, as the TPU kernel
//      does (attention_prefill_paged.py:117-122): those positions are in
//      flight in the chunk and each key counts once;
//   2. the chunk's own in-flight keys ck/cv, causal, in the input type also
//      over an int8 pool: the chunk is quantized only when it is written.
//
//   q [C, Hkv, G, dh], pool k/v [Pt, ps, Hkv, dh] (int8 with scales ks/vs
//   [Pt, ps, Hkv, 1] f32), kpos [Pt, ps] int32, table [nt] int32
//   (pre-clamped), qpos [C] int32, ck/cv [C, Hkv, dh] -> out [C, Hkv, G, dh]
//
// The caller launches it on the PRE-write pool and writes the chunk's K/V
// into its pages afterwards.  Masks, softcap and f32 arithmetic as in
// paged_attention.cuh.  The TPU wrapper's extra trash entry in the table is a
// detail of its index maps and is not needed here.
//
// One block per (kv-head, tile of 64 query rows), 256 threads; row = token *
// G + grouped head.  Trash entries are skipped; chunk-key tiles that lie
// entirely after the block's last query (causal) are skipped after reading
// their positions.
//
// Bound: the live pages' K/V plus q, ck, cv and out are read or written once;
// the work is 4 * H * dh operations per unmasked (query, key) pair.  At a
// 256-token chunk over about 1000 tokens of history the operations bound it
// at the tensor cores' rate; this kernel does its products with FMA on the
// CUDA cores out of shared memory (each score is one thread's dot product),
// so it runs well above that bound.  Tensor-core tiles (mma / wgmma) over
// the staged K/V are later work.
#include "paged_attention.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int RT = 64;   // query rows (token x grouped head) per block

template <typename T, int DH, typename KV>
__global__ void __launch_bounds__(NT) prefill_kernel(
    const T* __restrict__ q, const KV pool, const int* __restrict__ kpos,
    const int* __restrict__ table, const int* __restrict__ qpos, const T* __restrict__ ck,
    const T* __restrict__ cv, T* __restrict__ out, int C, int Hkv, int G, int ps, int nt, int Pt,
    paged::Mask mk) {
  using A = paged::Attn<T, DH, RT, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  A a(*reinterpret_cast<typename A::Smem*>(smem), mk);
  const int h = blockIdx.x, row0 = blockIdx.y * RT;
  a.load_queries(q, qpos, Hkv, h, G, row0, min(RT, C * G - row0));
  a.attend_pool(pool, kpos, table, nt, ps, Pt, Hkv, h, qpos[0]);
  a.attend_chunk(ck, cv, qpos, C, Hkv, h);
  a.store(out, Hkv, h, G, row0);
}

template <typename T, int DH, typename KV>
int launch(const void* q, const KV& pool, const void* kpos, const void* table, const void* qpos,
           const void* ck, const void* cv, void* out, int C, int Hkv, int G, int ps, int nt, int Pt,
           const paged::Mask& mk, void* stream) {
  const int smem = (int)sizeof(typename paged::Attn<T, DH, RT, NT>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_kernel<T, DH, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(Hkv, (C * G + RT - 1) / RT);
  prefill_kernel<T, DH, KV><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), pool, static_cast<const int*>(kpos),
      static_cast<const int*>(table), static_cast<const int*>(qpos), static_cast<const T*>(ck),
      static_cast<const T*>(cv), static_cast<T*>(out), C, Hkv, G, ps, nt, Pt, mk);
  return cudaGetLastError();
}

template <typename T, typename KV>
int dispatch(const void* q, const KV& pool, const void* kpos, const void* table, const void* qpos,
             const void* ck, const void* cv, void* out, int C, int Hkv, int G, int dh, int ps,
             int nt, int Pt, float scale, int causal, int window, float softcap, void* stream) {
  if (C < 1 || G < 1 || ps < 1 || ps > paged::KT || Hkv < 1 || nt < 0)
    return cudaErrorInvalidValue;
  const paged::Mask mk{scale, softcap, causal, window};
  switch (dh) {
    case 32: return launch<T, 32>(q, pool, kpos, table, qpos, ck, cv, out, C, Hkv, G, ps, nt, Pt, mk, stream);
    case 64: return launch<T, 64>(q, pool, kpos, table, qpos, ck, cv, out, C, Hkv, G, ps, nt, Pt, mk, stream);
    case 128: return launch<T, 128>(q, pool, kpos, table, qpos, ck, cv, out, C, Hkv, G, ps, nt, Pt, mk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_prefill_attention_bf16(const void* q, const void* k, const void* v,
                                            const void* kpos, const void* table, const void* qpos,
                                            const void* ck, const void* cv, void* out, int C,
                                            int Hkv, int G, int dh, int ps, int nt, int Pt,
                                            float scale, int causal, int window, float softcap,
                                            void* stream) {
  return dispatch<__nv_bfloat16>(q, paged::kv_fp<__nv_bfloat16>(k, v), kpos, table, qpos, ck, cv,
                                 out, C, Hkv, G, dh, ps, nt, Pt, scale, causal, window, softcap,
                                 stream);
}

extern "C" int paged_prefill_attention_f32(const void* q, const void* k, const void* v,
                                           const void* kpos, const void* table, const void* qpos,
                                           const void* ck, const void* cv, void* out, int C,
                                           int Hkv, int G, int dh, int ps, int nt, int Pt,
                                           float scale, int causal, int window, float softcap,
                                           void* stream) {
  return dispatch<float>(q, paged::kv_fp<float>(k, v), kpos, table, qpos, ck, cv, out, C, Hkv, G,
                         dh, ps, nt, Pt, scale, causal, window, softcap, stream);
}

// Kernel 8q, the int8 pool: k/v int8 [Pt, ps, Hkv, dh], ks/vs f32 [Pt, ps, Hkv, 1];
// ck/cv stay in the input type.
extern "C" int paged_prefill_attention_int8_bf16(const void* q, const void* k, const void* ks,
                                                 const void* v, const void* vs, const void* kpos,
                                                 const void* table, const void* qpos,
                                                 const void* ck, const void* cv, void* out, int C,
                                                 int Hkv, int G, int dh, int ps, int nt, int Pt,
                                                 float scale, int causal, int window,
                                                 float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, paged::kv_q8(k, ks, v, vs), kpos, table, qpos, ck, cv, out, C,
                                 Hkv, G, dh, ps, nt, Pt, scale, causal, window, softcap, stream);
}

extern "C" int paged_prefill_attention_int8_f32(const void* q, const void* k, const void* ks,
                                                const void* v, const void* vs, const void* kpos,
                                                const void* table, const void* qpos,
                                                const void* ck, const void* cv, void* out, int C,
                                                int Hkv, int G, int dh, int ps, int nt, int Pt,
                                                float scale, int causal, int window, float softcap,
                                                void* stream) {
  return dispatch<float>(q, paged::kv_q8(k, ks, v, vs), kpos, table, qpos, ck, cv, out, C, Hkv, G,
                         dh, ps, nt, Pt, scale, causal, window, softcap, stream);
}
