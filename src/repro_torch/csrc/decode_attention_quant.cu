// Decode attention over a contiguous int8 KV cache for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/attention_quant.py::decode_attention_quant
// (its pallas_call), kernel 9.  One decode token per slot attends over its
// row of a contiguous cache stored as int8 values with one f32 scale per
// (timestep, kv-head), quantized when each token was written
// (repro_torch/quant/kv.py):
//
//   q [B, Hkv, G, dh], kq/vq int8 [B, T, Hkv, dh], ks/vs f32 [B, T, Hkv, 1],
//   kpos [B, T] int32 (absolute position per slot, -1 empty), qpos [B] int32
//   -> out [B, Hkv, G, dh]
//
// with validity (kpos >= 0) / causal / window masks, softcap, f32 scores,
// softmax and accumulation, output in the input type.  Masked entries get
// probability 0 explicitly, as in kernels 7 and 8, so a row with no valid key
// gives 0.  The TPU kernel lacks that guard (attention_quant.py:69) and gives
// such a row a uniform average; the engines never read one (a decode token
// always sees itself).
//
// Head dims 32, 64, 128 and 256 (recurrentgemma-2b's int8 rings; at 256 the
// query rows stay in shared memory and their A fragments are reloaded for
// every tile, paged_mma.cuh's scores_smem_q: a simple, unoptimised instance).
//
// bf16 (the served path): kernel 7q's split-K tile walk (paged_mma.cuh) over
// the contiguous row, which it reads as implicit pages of 64 keys (key i of
// row b is cache row b * T + i; no table, no compaction; windows of 256
// tiles, 16384 keys).
//   1. Grid (Hkv, B, splits).  Every block of a row reads the row's
//      positions in bulk (mma_sm90.cuh's mark_tiles) and marks the 64-key
//      tiles that hold a key valid for the query (kpos >= 0, causal, inside
//      the window) and those whose every key is valid (no per-entry mask
//      there).  Liveness comes from the positions, never from the slot
//      index, so a window layer's ring whose live slots wrap and a static
//      cache sized max_prefill + max_decode but mostly empty both read only
//      the tiles that hold a valid key.
//   2. The block of split s takes the live tiles of rank
//      [s * L / splits, (s + 1) * L / splits) of a window's L.
//   3. K/V tiles (int8, zero-filled past T), their positions (-1 past T) and
//      per-key scales (one 4-byte cp.async each: a head's scales are strided
//      by Hkv floats) are double-buffered with cp.async; int8 lands raw and
//      is widened exactly in shared memory (mma_sm90.cuh's int8x4_to_bf16).
//      K's scale goes on the score column and V's is folded into P before P
//      is rounded to bf16, so the products are (q . k) * s_k and
//      sum p * s_v * v in f32, as the TPU kernel's f32 dequantization.
//   4. S = Q K^T and P V on mma.sync m16n8k16 (bf16 in, f32 accumulate), the
//      G <= 16 query heads of the kv-head as one 16-row A tile; each warp
//      takes 16 keys of a tile with its own online softmax; the warps merge
//      in shared memory and the block writes f32 partials (m, l, the
//      unnormalised accumulator) to the wrapper's workspace, merged by
//      paged_mma::merge_splits, a second launch; one split writes out
//      itself.
// The split count comes from static shapes only (the wrapper's
// decode_splits over ceil(T / 64) tiles: about two blocks per SM, never more
// splits than tiles), so the call reads no device value on the host and can
// be captured in a CUDA graph.
//
// f32 (reduced checks): unsplit, one block per (kv-head, slot) on CUDA cores,
// paged_attention.cuh's Attn walking the row's keys in order.
//
// Bound: the keys the query attends to are read once, dh + 4 bytes each of K
// and of V per kv-head (half the bytes of a bf16 cache at dh = 128), plus
// every slot's position; 4 * H * dh operations per unmasked (query, key)
// pair, about one per byte, far below the card's 295 operations per byte, so
// the least time is those bytes over 3.35 TB/s.  What remains above it: a
// block keeps one tile in flight beside the one it computes, every split
// reads the row's positions before its first tile, and the merge launch and
// the partials' round trip cost a few microseconds that a short row does
// not amortise.
#include "paged_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: split-K on tensor cores (paged_mma.cuh), then the merge
// ---------------------------------------------------------------------------

struct Params {
  const bf16* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* kpos;
  const int* qpos;
  bf16* out;
  float* ws;  // split-K partials (paged_mma::partial_m / _l / _acc), R = B * Hkv * G rows
  int B, Hkv, G, T;
  paged::Mask mk;
};

template <int DH>
__global__ void __launch_bounds__(paged_mma::NT) decode_quant_split_kernel(const Params p) {
  using namespace paged_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t key0 = (size_t)b * p.T;  // the row's first cache row
  const Src src{p.kq + key0 * p.Hkv * DH, p.vq + key0 * p.Hkv * DH, p.ks + key0 * p.Hkv,
                p.vs + key0 * p.Hkv, p.kpos + key0, nullptr, nullptr, nullptr, nullptr,
                BK, 0, p.Hkv, h, 0, INT_MAX, p.T};
  const size_t row0 = ((size_t)b * p.Hkv + h) * p.G;
  decode_block<DH, true, 1>(*reinterpret_cast<Smem<DH, true, 1>*>(smem_raw), src, p.q + row0 * DH,
                            p.G, __ldg(p.qpos + b), p.mk, true, (p.T + BK - 1) / BK, blockIdx.z,
                            gridDim.z, p.out, p.ws, (size_t)p.B * p.Hkv * p.G, row0);
}

template <int DH>
int launch_split(const Params& p, int splits, cudaStream_t stream) {
  const int smem = (int)sizeof(paged_mma::Smem<DH, true, 1>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_quant_split_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  decode_quant_split_kernel<DH><<<dim3(p.Hkv, p.B, splits), paged_mma::NT, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return paged_mma::launch_merge<DH>(p.ws, p.out, p.B * p.Hkv * p.G, splits, stream);
}

int dispatch_split(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
                   const void* kpos, const void* qpos, void* out, void* ws, int B, int Hkv, int G,
                   int dh, int T, int splits, float scale, int causal, int window, float softcap,
                   void* stream) {
  if (G < 1 || G > paged_mma::GR || B < 1 || Hkv < 1 || T < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const Params p{static_cast<const bf16*>(q), static_cast<const int8_t*>(kq),
                 static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
                 static_cast<const float*>(vs), static_cast<const int*>(kpos),
                 static_cast<const int*>(qpos), static_cast<bf16*>(out), static_cast<float*>(ws),
                 B, Hkv, G, T, paged::Mask{scale, softcap, causal, window}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_split<32>(p, splits, st);
    case 64: return launch_split<64>(p, splits, st);
    case 128: return launch_split<128>(p, splits, st);
    case 256: return launch_split<256>(p, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, the shared code of paged_attention.cuh
// ---------------------------------------------------------------------------

constexpr int RT = 16;   // query rows per block: G <= 16

template <int DH>
constexpr int kThreads = DH > 128 ? DH : 128;  // a multiple of DH

template <int DH>
__global__ void __launch_bounds__(kThreads<DH>) decode_quant_kernel(
    const float* __restrict__ q, const paged::KVq8 cache, const int* __restrict__ kpos,
    const int* __restrict__ qpos, float* __restrict__ out, int Hkv, int G, int T_, paged::Mask mk) {
  using A = paged::Attn<float, DH, RT, kThreads<DH>>;
  extern __shared__ __align__(16) unsigned char smem[];
  A a(*reinterpret_cast<typename A::Smem*>(smem), mk);
  const int h = blockIdx.x, b = blockIdx.y;
  a.load_queries(q, qpos, Hkv, h, G, b * G, G);
  a.attend_contiguous(cache, kpos + (size_t)b * T_, T_, (size_t)b * T_, Hkv, h);
  a.store(out, Hkv, h, G, b * G);
}

template <int DH>
int launch(const void* q, const paged::KVq8& cache, const void* kpos, const void* qpos, void* out,
           int B, int Hkv, int G, int T_, const paged::Mask& mk, void* stream) {
  const int smem = (int)sizeof(typename paged::Attn<float, DH, RT, kThreads<DH>>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_quant_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  decode_quant_kernel<DH><<<dim3(Hkv, B), kThreads<DH>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), cache, static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), static_cast<float*>(out), Hkv, G, T_, mk);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
             const void* kpos, const void* qpos, void* out, int B, int Hkv, int G, int dh, int T_,
             float scale, int causal, int window, float softcap, void* stream) {
  if (G < 1 || G > RT || B < 1 || Hkv < 1 || T_ < 1) return cudaErrorInvalidValue;
  const paged::Mask mk{scale, softcap, causal, window};
  const paged::KVq8 cache = paged::kv_q8(kq, ks, vq, vs);
  switch (dh) {
    case 32: return launch<32>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    case 64: return launch<64>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    case 128: return launch<128>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    case 256: return launch<256>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, out (and the bf16
// entry's workspace ws of splits * B * Hkv * G * (dh + 2) floats, unused at
// one split) allocated by the caller, stream a cudaStream_t; returns
// cudaGetLastError() (0 = success).
extern "C" int decode_attention_quant_bf16(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, const void* kpos,
                                           const void* qpos, void* out, void* ws, int B,
                                           int Hkv, int G, int dh, int T, int splits,
                                           float scale, int causal, int window, float softcap,
                                           void* stream) {
  return dispatch_split(q, kq, ks, vq, vs, kpos, qpos, out, ws, B, Hkv, G, dh, T, splits,
                        scale, causal, window, softcap, stream);
}

extern "C" int decode_attention_quant_f32(const void* q, const void* kq, const void* ks,
                                          const void* vq, const void* vs, const void* kpos,
                                          const void* qpos, void* out, int B, int Hkv, int G,
                                          int dh, int T, float scale, int causal, int window,
                                          float softcap, void* stream) {
  return dispatch(q, kq, ks, vq, vs, kpos, qpos, out, B, Hkv, G, dh, T, scale, causal, window,
                  softcap, stream);
}
