// Decode attention over a contiguous int8 KV cache for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/attention_quant.py::decode_attention_quant
// (its pallas_call).  One decode token per slot attends over its row of a
// contiguous cache stored as int8 values with one f32 scale per (timestep,
// kv-head), quantized when each token was written (repro_torch/quant/kv.py):
//
//   q [B, Hkv, G, dh], kq/vq int8 [B, T, Hkv, dh], ks/vs f32 [B, T, Hkv, 1],
//   kpos [B, T] int32 (absolute position per slot, -1 empty), qpos [B] int32
//   -> out [B, Hkv, G, dh]
//
// with validity (kpos >= 0) / causal / window masks, softcap, f32 scores,
// softmax and accumulation, output in the input type.  Each K/V value is
// widened and multiplied by its scale in f32 while its tile is staged, as the
// TPU kernel dequantizes in VMEM; the staging, masks and online softmax are
// the shared code of paged_attention.cuh, walking the row's keys in order
// (t0 .. t0 + 31) instead of through a block table.
//
// Masked entries get probability 0 explicitly, as in kernels 7 and 8, so a
// row with no valid key gives 0.  The TPU kernel lacks that guard
// (attention_quant.py:69) and gives such a row a uniform average; the engines
// never read one (a decode token always sees itself).
//
// One block per (kv-head, slot), 128 threads: the G query heads of a kv-head
// share every staged tile.  A tile whose keys are all masked for the query
// (empty slots past the written prefix, keys outside the window) is skipped
// after reading its positions.
//
// Bound: the keys the query attends to are read once, dh + 4 bytes each of K
// and of V per kv-head (half the bytes of a bf16 cache at dh = 128), plus
// every slot's position; 4 * H * dh operations per unmasked (query, key)
// pair, about one per byte, far below the card's 295 operations per byte, so
// the least time is those bytes over 3.35 TB/s.  As kernel 7, this simple
// version keeps one tile in flight per block and B * Hkv blocks (32 at B = 4)
// leave most SMs idle; split-K over the row and deeper loads are later work.
#include "paged_attention.cuh"

namespace {

constexpr int NT = 128;  // threads per block
constexpr int RT = 16;   // query rows per block: G <= 16

template <typename T, int DH>
__global__ void __launch_bounds__(NT) decode_quant_kernel(
    const T* __restrict__ q, const paged::KVq8 cache, const int* __restrict__ kpos,
    const int* __restrict__ qpos, T* __restrict__ out, int Hkv, int G, int T_, paged::Mask mk) {
  using A = paged::Attn<T, DH, RT, NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  A a(*reinterpret_cast<typename A::Smem*>(smem), mk);
  const int h = blockIdx.x, b = blockIdx.y;
  a.load_queries(q, qpos, Hkv, h, G, b * G, G);
  a.attend_contiguous(cache, kpos + (size_t)b * T_, T_, (size_t)b * T_, Hkv, h);
  a.store(out, Hkv, h, G, b * G);
}

template <typename T, int DH>
int launch(const void* q, const paged::KVq8& cache, const void* kpos, const void* qpos, void* out,
           int B, int Hkv, int G, int T_, const paged::Mask& mk, void* stream) {
  const int smem = (int)sizeof(typename paged::Attn<T, DH, RT, NT>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_quant_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  decode_quant_kernel<T, DH><<<dim3(Hkv, B), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), cache, static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), static_cast<T*>(out), Hkv, G, T_, mk);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
             const void* kpos, const void* qpos, void* out, int B, int Hkv, int G, int dh, int T_,
             float scale, int causal, int window, float softcap, void* stream) {
  if (G < 1 || G > RT || B < 1 || Hkv < 1 || T_ < 1) return cudaErrorInvalidValue;
  const paged::Mask mk{scale, softcap, causal, window};
  const paged::KVq8 cache = paged::kv_q8(kq, ks, vq, vs);
  switch (dh) {
    case 32: return launch<T, 32>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    case 64: return launch<T, 64>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    case 128: return launch<T, 128>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, out allocated by the
// caller, stream a cudaStream_t; returns cudaGetLastError() (0 = success).
extern "C" int decode_attention_quant_bf16(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, const void* kpos,
                                           const void* qpos, void* out, int B, int Hkv, int G,
                                           int dh, int T, float scale, int causal, int window,
                                           float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, kq, ks, vq, vs, kpos, qpos, out, B, Hkv, G, dh, T, scale,
                                 causal, window, softcap, stream);
}

extern "C" int decode_attention_quant_f32(const void* q, const void* kq, const void* ks,
                                          const void* vq, const void* vs, const void* kpos,
                                          const void* qpos, void* out, int B, int Hkv, int G,
                                          int dh, int T, float scale, int causal, int window,
                                          float softcap, void* stream) {
  return dispatch<float>(q, kq, ks, vq, vs, kpos, qpos, out, B, Hkv, G, dh, T, scale, causal,
                         window, softcap, stream);
}
