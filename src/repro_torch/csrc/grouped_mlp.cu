// Grouped (dropless) expert SwiGLU MLP for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/expert_mlp_grouped.py::grouped_mlp_kernel
// (its pallas_call).  The dispatch layer (repro_torch/core/dispatch_grouped.py)
// has sorted the tokens by expert into xg [Ct, D], padded per expert to the
// 8-row tile, and names each tile's expert in te [Ct/8].  For every tile t with
// e = te[t]:
//
//     out[t] = (silu(x . wg[e]) * (x . wi[e])) . wo[e]
//
// products accumulated in f32, the activation rounded to the input type before
// the down-projection, the output summed in f32 over all of F and cast to the
// input type, as on the TPU.  T is __nv_bfloat16 (the serving path) or float.
//
// Two kernels, both deterministic (no atomics):
//   1. up/gate: grid (tile, F/128).  Each block forms act [8, 128] for its tile
//      and writes it to a [Ct, F] scratch in device memory.
//   2. down:    grid (tile, D/128).  Each block sums act[8, :] . wo[e][:, 128 cols].
// Inside a block, 8 warps split the contraction dimension; each lane owns 4
// adjacent output columns (one 8-byte bf16 or 16-byte f32 load per weight row),
// so a warp reads 128 contiguous columns of one weight row.  The x (or act)
// rows of the tile are staged through shared memory as f32, and the 8 warps'
// partial sums are added in a fixed order through shared memory.
//
// Bound: at decode and prefill sizes the kernel streams the weights of every
// expert the tiles touch, n_distinct_experts * 3*D*F * sizeof(T) bytes, and
// does 2*rows*3*D*F operations, far below the card's 295 operations per byte;
// so its least time is those bytes over 3.35 TB/s.  Adjacent tiles of one
// expert run as adjacent blocks, so the second tile's weight reads mostly hit
// L2.  The TPU kernel kept the [8, F] activation in VMEM and accumulated the
// down-projection across the F grid axis; this kernel does not yet: the
// activation makes one round trip through device memory (Ct*F*sizeof(T) bytes
// each way, small beside the weights).  Plain FMA, no tensor cores: wgmma,
// TMA and fusing the two passes are later work.
//
// Tiles at or past rows_used (a device scalar: the rows the real groups fill)
// hold no token: kernel 1 skips them and kernel 2 writes zeros, which is what
// silu(0)*0 . wo gives, so the result is bit-identical to walking them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 8;               // token rows per tile == GROUPED_TILE
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 4;               // output columns per lane
constexpr int BN = 32 * COLS;         // output columns per block
constexpr int BK = 256;               // contraction rows staged per step
constexpr int OUT_PER_THREAD = TILE * BN / THREADS;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ void load4(const float* p, float v[COLS]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[COLS]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Shared memory of one block: the staged rows of the tile, then (after the
// contraction) the warps' partial sums.  The two uses never overlap in time.
union Smem {
  float rows[TILE][BK];
  float part[WARPS][TILE][BN];
};

// acc[r][c] += sum_k a[row0 + r, k] * W[k, col + c] over k in [0, K), for NW
// weight matrices at once.  Warp w takes rows k = w, w + 8, ... of each staged
// block; every lane reads its 4 columns of that row.
template <typename T, int NW>
__device__ __forceinline__ void contract(const T* __restrict__ a, int lda, int row0, int K,
                                         const T* const* w, int ldw, int col, bool active,
                                         Smem& sm, float acc[NW][TILE][COLS]) {
  const int warp = threadIdx.x / 32;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kn = min(BK, K - k0);
    for (int i = threadIdx.x; i < TILE * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      sm.rows[r][c] = c < kn ? to_f32(a[(size_t)(row0 + r) * lda + k0 + c]) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int k = warp; k < kn; k += WARPS) {
        float wv[NW][COLS];
#pragma unroll
        for (int m = 0; m < NW; ++m) load4(w[m] + (size_t)(k0 + k) * ldw + col, wv[m]);
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
          const float xv = sm.rows[r][k];
#pragma unroll
          for (int m = 0; m < NW; ++m)
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[m][r][c] = fmaf(xv, wv[m][c], acc[m][r][c]);
        }
      }
    }
    __syncthreads();
  }
}

// Sum the 8 warps' partials of acc in warp order; thread i gets outputs
// i, i + THREADS, ... of the block's [TILE, BN] tile (row-major).
__device__ __forceinline__ void reduce_warps(const float acc[TILE][COLS], Smem& sm,
                                             float out[OUT_PER_THREAD]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < TILE; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) sm.part[warp][r][lane * COLS + c] = acc[r][c];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    const int r = idx / BN, c = idx % BN;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += sm.part[w][r][c];
    out[j] = s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
up_gate_kernel(const T* __restrict__ xg, const int32_t* __restrict__ te,
               const int32_t* __restrict__ rows_used, const T* __restrict__ wi,
               const T* __restrict__ wg, T* __restrict__ act, int D, int F) {
  const int row0 = blockIdx.x * TILE;
  if (row0 >= *rows_used) return;
  const size_t e = (size_t)te[blockIdx.x];
  const int col0 = blockIdx.y * BN;
  const int col = col0 + (threadIdx.x % 32) * COLS;
  const T* w[2] = {wi + e * D * F, wg + e * D * F};
  __shared__ Smem sm;
  float acc[2][TILE][COLS] = {};
  contract<T, 2>(xg, D, row0, D, w, F, col, col < F, sm, acc);
  float h[OUT_PER_THREAD], g[OUT_PER_THREAD];
  reduce_warps(acc[0], sm, h);
  reduce_warps(acc[1], sm, g);
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    const int r = idx / BN, c = col0 + idx % BN;
    if (c < F) {
      const float silu = g[j] / (1.f + expf(-g[j]));
      act[(size_t)(row0 + r) * F + c] = from_f32<T>(silu * h[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
down_kernel(const T* __restrict__ act, const int32_t* __restrict__ te,
            const int32_t* __restrict__ rows_used, const T* __restrict__ wo,
            T* __restrict__ out, int D, int F) {
  const int row0 = blockIdx.x * TILE;
  const int col0 = blockIdx.y * BN;
  if (row0 >= *rows_used) {
    for (int i = threadIdx.x; i < TILE * BN; i += THREADS) {
      const int r = i / BN, c = col0 + i % BN;
      if (c < D) out[(size_t)(row0 + r) * D + c] = from_f32<T>(0.f);
    }
    return;
  }
  const size_t e = (size_t)te[blockIdx.x];
  const int col = col0 + (threadIdx.x % 32) * COLS;
  const T* w[1] = {wo + e * F * D};
  __shared__ Smem sm;
  float acc[1][TILE][COLS] = {};
  contract<T, 1>(act, F, row0, F, w, D, col, col < D, sm, acc);
  float y[OUT_PER_THREAD];
  reduce_warps(acc[0], sm, y);
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    const int r = idx / BN, c = col0 + idx % BN;
    if (c < D) out[(size_t)(row0 + r) * D + c] = from_f32<T>(y[j]);
  }
}

template <typename T>
int launch(const void* xg, const void* te, const void* rows_used, const void* wi,
           const void* wg, const void* wo, void* act, void* out, int n_tiles, int D, int F,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(THREADS);
  up_gate_kernel<T><<<dim3(n_tiles, (F + BN - 1) / BN), block, 0, s>>>(
      static_cast<const T*>(xg), static_cast<const int32_t*>(te),
      static_cast<const int32_t*>(rows_used), static_cast<const T*>(wi),
      static_cast<const T*>(wg), static_cast<T*>(act), D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down_kernel<T><<<dim3(n_tiles, (D + BN - 1) / BN), block, 0, s>>>(
      static_cast<const T*>(act), static_cast<const int32_t*>(te),
      static_cast<const int32_t*>(rows_used), static_cast<const T*>(wo),
      static_cast<T*>(out), D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers; act is
// a [Ct, F] scratch and out [Ct, D], both allocated by the caller; stream is a
// cudaStream_t.  Returns cudaGetLastError() after the launches (0 = success).
extern "C" {

int grouped_mlp_bf16(const void* xg, const void* te, const void* rows_used, const void* wi,
                     const void* wg, const void* wo, void* act, void* out, int n_tiles, int D,
                     int F, void* stream) {
  return launch<__nv_bfloat16>(xg, te, rows_used, wi, wg, wo, act, out, n_tiles, D, F, stream);
}

int grouped_mlp_f32(const void* xg, const void* te, const void* rows_used, const void* wi,
                    const void* wg, const void* wo, void* act, void* out, int n_tiles, int D,
                    int F, void* stream) {
  return launch<float>(xg, te, rows_used, wi, wg, wo, act, out, n_tiles, D, F, stream);
}

}  // extern "C"
