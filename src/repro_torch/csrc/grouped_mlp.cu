// Grouped (dropless) expert SwiGLU MLP for Hopper, sm_90a.
//
// Replaces the TPU kernels repro/kernels/expert_mlp_grouped.py::grouped_mlp_kernel
// (kernel 4, weights in the input type) and ::grouped_mlp_quant_kernel (kernel
// 5, MoQ weights: int8, or int4 packed two per byte, with one f32 scale per
// output column), each at its pallas_call.  The dispatch layer (repro_torch/core/dispatch_grouped.py)
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
// Quantized weights (kernel 5): wi/wg [E, D, F] and wo [E, F, D] as int8, or
// as int4 [E, D/2, F] / [E, F/2, D], packed along the contraction axis (byte
// (r, n) holds contraction rows 2r in its low and 2r+1 in its high nibble,
// sign-extended); scales wi_s/wg_s [E, 1, F], wo_s [E, 1, D].  Each weight is
// widened, times its column's scale in f32, and rounded to T before its FMA,
// as the TPU kernel dequantizes in VMEM and casts to the activation type.
//
// Two kernels, both deterministic (no atomics):
//   1. up/gate: grid (tile, F/128).  Each block forms act [8, 128] for its tile
//      and writes it to a [Ct, F] scratch in device memory.
//   2. down:    grid (tile, D/128).  Each block sums act[8, :] . wo[e][:, 128 cols].
// Inside a block, 8 warps split the contraction dimension; each lane owns 4
// adjacent output columns (one 8-byte bf16 or 16-byte f32 load per weight row),
// so a warp reads 128 contiguous columns of one weight row (int8: 4 bytes per
// lane; int4: 4 bytes per lane give 2 contraction rows x 4 columns).  The x (or act)
// rows of the tile are staged through shared memory as f32, and the 8 warps'
// partial sums are added in a fixed order through shared memory.
//
// Bound: at decode and prefill sizes the kernel streams the weights of every
// expert the tiles touch, n_distinct_experts * 3*D*F * sizeof(T) bytes, and
// does 2*rows*3*D*F operations, far below the card's 295 operations per byte;
// so its least time is those bytes over 3.35 TB/s.  int8 weights halve those
// bytes against bf16 and int4 quarter them (plus 4 bytes of scale per column
// per matrix).  Adjacent tiles of one
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
//
// The same device code also serves the capacity dispatch (core/dispatch.py):
// it replaces repro/kernels/expert_mlp.py::expert_mlp_kernel (TPU kernel 2,
// weights in the input type) and repro/kernels/expert_mlp_quant.py::
// expert_mlp_quant_kernel (TPU kernel 3, int8 weights with f32 column
// scales; for bf16 activations at widths that are multiples of 256 it runs
// on the tensor cores in grouped_mlp_mma.cu, and here only for f32 and other
// widths), over the mapping table's [E, C, D] buffer viewed as [E*C, D].  C
// is a multiple of 8, so tile t belongs to expert t / (C/8), and the gating
// kernel's per-expert counts (fill) take the place of rows_used: a tile
// whose first row is at or past its expert's fill holds only zero rows (the
// dispatch scatters into zeros), so it reads no weight and gives zeros, as
// above.  At decode the buffer is [128, 8, D] for 4 tokens and only the
// tiles of the (at most 4) experts with tokens read weights: kernel 4's
// bytes.  The capacity kernels (up_gate_capacity_kernel, down_capacity_kernel)
// repeat the two grouped kernels' bodies with their own tile -> expert rule
// and share every helper: with the rule as a template argument of one pair
// of kernels, ptxas allocated kernel 5's registers differently and it ran
// slower, so kernels 4 and 5 keep their own code.  The int8 capacity
// kernels (kernel 3) are capped at 128 registers a thread, so that two
// blocks share an SM: unbounded, ptxas gave up/gate more than 128 registers
// (one block per SM) and kernel 3 ran slower at decode.  The fp capacity
// kernels (kernel 2) keep kernel 4's bounds: capped, they ran faster at
// decode but slower at T = 256, and a minimum of one block (rather than none
// given) let ptxas take more registers and made them slower at T = 256.
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

__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// One expert's weight matrix [K, N] as a lane reads it: PACK contraction rows
// per stored row, COLS adjacent columns from column col.  BITS = 0: the input
// type T; 8: int8; 4: int4 nibbles (PACK 2).  The quantized formats carry the
// lane's column scales and return each weight dequantized and rounded to T.
template <typename T, int BITS>
struct Weights {
  static constexpr int PACK = BITS == 4 ? 2 : 1;
  const void* w;   // this expert's stored rows [K / PACK, N]
  float sc[COLS];  // scales of the lane's columns (quantized formats)

  __device__ __forceinline__ Weights(const void* base, const float* scales, size_t e, int K, int N,
                                     int col, bool active) {
    if constexpr (BITS == 0) {
      w = static_cast<const T*>(base) + e * K * N;
    } else {
      w = static_cast<const int8_t*>(base) + e * (K / PACK) * N;
#pragma unroll
      for (int c = 0; c < COLS; ++c) sc[c] = active ? __ldg(scales + e * N + col + c) : 0.f;
    }
  }

  __device__ __forceinline__ void load(int row, int N, int col, float v[PACK][COLS]) const {
    if constexpr (BITS == 0) {
      load4(static_cast<const T*>(w) + (size_t)row * N + col, v[0]);
    } else if constexpr (BITS == 8) {
      const char4 q = __ldg(reinterpret_cast<const char4*>(static_cast<const int8_t*>(w) +
                                                           (size_t)row * N + col));
      const float f[COLS] = {(float)q.x, (float)q.y, (float)q.z, (float)q.w};
#pragma unroll
      for (int c = 0; c < COLS; ++c) v[0][c] = round_to(f[c] * sc[c], (T*)nullptr);
    } else {
      const uchar4 q = __ldg(reinterpret_cast<const uchar4*>(static_cast<const int8_t*>(w) +
                                                             (size_t)row * N + col));
      const int b[COLS] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        int lo = b[c] & 0xF, hi = (b[c] >> 4) & 0xF;
        lo -= 16 * (lo > 7);
        hi -= 16 * (hi > 7);
        v[0][c] = round_to((float)lo * sc[c], (T*)nullptr);
        v[1][c] = round_to((float)hi * sc[c], (T*)nullptr);
      }
    }
  }
};

// Shared memory of one block: the staged rows of the tile, then (after the
// contraction) the warps' partial sums.  The two uses never overlap in time.
union Smem {
  float rows[TILE][BK];
  float part[WARPS][TILE][BN];
};

// acc[r][c] += sum_k a[row0 + r, k] * W[k, col + c] over k in [0, K), for NW
// weight matrices at once.  Warp w takes stored rows kp = w, w + 8, ... of
// each staged block (contraction rows kp * PACK .. kp * PACK + PACK - 1, in
// order); every lane reads its 4 columns of that row.
template <typename T, int BITS, int NW>
__device__ __forceinline__ void contract(const T* __restrict__ a, int lda, int row0, int K,
                                         const Weights<T, BITS>* w, int ldw, int col, bool active,
                                         Smem& sm, float acc[NW][TILE][COLS]) {
  constexpr int PACK = Weights<T, BITS>::PACK;
  // Loads kept in flight per warp: a quantized row is 4 bytes per lane, half
  // or a quarter of the input type's, so its loop is unrolled deeper to keep
  // as many bytes in flight (decode runs a handful of tiles, too few blocks
  // to hide the load latency otherwise).
  constexpr int UNROLL = BITS == 0 ? 4 : 16 / NW;
  const int warp = threadIdx.x / 32;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kn = min(BK, K - k0);
    for (int i = threadIdx.x; i < TILE * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      sm.rows[r][c] = c < kn ? to_f32(a[(size_t)(row0 + r) * lda + k0 + c]) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll UNROLL
      for (int kp = warp; kp < kn / PACK; kp += WARPS) {
        float wv[NW][PACK][COLS];
#pragma unroll
        for (int m = 0; m < NW; ++m) w[m].load(k0 / PACK + kp, ldw, col, wv[m]);
#pragma unroll
        for (int r = 0; r < TILE; ++r) {
#pragma unroll
          for (int p = 0; p < PACK; ++p) {
            const float xv = sm.rows[r][kp * PACK + p];
#pragma unroll
            for (int m = 0; m < NW; ++m)
#pragma unroll
              for (int c = 0; c < COLS; ++c) acc[m][r][c] = fmaf(xv, wv[m][p][c], acc[m][r][c]);
          }
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

template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS)
up_gate_kernel(const T* __restrict__ xg, const int32_t* __restrict__ te,
               const int32_t* __restrict__ rows_used, const void* __restrict__ wi,
               const float* __restrict__ wi_s, const void* __restrict__ wg,
               const float* __restrict__ wg_s, T* __restrict__ act, int D, int F) {
  const int row0 = blockIdx.x * TILE;
  if (row0 >= *rows_used) return;
  const size_t e = (size_t)te[blockIdx.x];
  const int col0 = blockIdx.y * BN;
  const int col = col0 + (threadIdx.x % 32) * COLS;
  const Weights<T, BITS> w[2] = {Weights<T, BITS>(wi, wi_s, e, D, F, col, col < F),
                                 Weights<T, BITS>(wg, wg_s, e, D, F, col, col < F)};
  __shared__ Smem sm;
  float acc[2][TILE][COLS] = {};
  contract<T, BITS, 2>(xg, D, row0, D, w, F, col, col < F, sm, acc);
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

template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS)
down_kernel(const T* __restrict__ act, const int32_t* __restrict__ te,
            const int32_t* __restrict__ rows_used, const void* __restrict__ wo,
            const float* __restrict__ wo_s, T* __restrict__ out, int D, int F) {
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
  const Weights<T, BITS> w[1] = {Weights<T, BITS>(wo, wo_s, e, F, D, col, col < D)};
  __shared__ Smem sm;
  float acc[1][TILE][COLS] = {};
  contract<T, BITS, 1>(act, F, row0, F, w, D, col, col < D, sm, acc);
  float y[OUT_PER_THREAD];
  reduce_warps(acc[0], sm, y);
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    const int r = idx / BN, c = col0 + idx % BN;
    if (c < D) out[(size_t)(row0 + r) * D + c] = from_f32<T>(y[j]);
  }
}

// Kernels 2 and 3 over the capacity buffer [E*C, D]: tile t holds rows
// (t % tpe) * TILE .. of expert t / tpe (tpe = C / TILE tiles per expert);
// rows at or past fill[e] hold no token (any fill >= the filled rows will
// do, the gating kernel's counts included).
template <typename T, int BITS>
__device__ __forceinline__ void up_gate_capacity(const T* __restrict__ xe,
                                                 const int32_t* __restrict__ fill, int tpe,
                                                 const void* __restrict__ wi,
                                                 const float* __restrict__ wi_s,
                                                 const void* __restrict__ wg,
                                                 const float* __restrict__ wg_s,
                                                 T* __restrict__ act, int D, int F) {
  const int row0 = blockIdx.x * TILE;
  const size_t e = (size_t)(blockIdx.x / tpe);
  if ((blockIdx.x % tpe) * TILE >= fill[e]) return;
  const int col0 = blockIdx.y * BN;
  const int col = col0 + (threadIdx.x % 32) * COLS;
  const Weights<T, BITS> w[2] = {Weights<T, BITS>(wi, wi_s, e, D, F, col, col < F),
                                 Weights<T, BITS>(wg, wg_s, e, D, F, col, col < F)};
  __shared__ Smem sm;
  float acc[2][TILE][COLS] = {};
  contract<T, BITS, 2>(xe, D, row0, D, w, F, col, col < F, sm, acc);
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

template <typename T, int BITS>
__device__ __forceinline__ void down_capacity(const T* __restrict__ act,
                                              const int32_t* __restrict__ fill, int tpe,
                                              const void* __restrict__ wo,
                                              const float* __restrict__ wo_s, T* __restrict__ out,
                                              int D, int F) {
  const int row0 = blockIdx.x * TILE;
  const int col0 = blockIdx.y * BN;
  const size_t e = (size_t)(blockIdx.x / tpe);
  if ((blockIdx.x % tpe) * TILE >= fill[e]) {
    for (int i = threadIdx.x; i < TILE * BN; i += THREADS) {
      const int r = i / BN, c = col0 + i % BN;
      if (c < D) out[(size_t)(row0 + r) * D + c] = from_f32<T>(0.f);
    }
    return;
  }
  const int col = col0 + (threadIdx.x % 32) * COLS;
  const Weights<T, BITS> w[1] = {Weights<T, BITS>(wo, wo_s, e, F, D, col, col < D)};
  __shared__ Smem sm;
  float acc[1][TILE][COLS] = {};
  contract<T, BITS, 1>(act, F, row0, F, w, D, col, col < D, sm, acc);
  float y[OUT_PER_THREAD];
  reduce_warps(acc[0], sm, y);
#pragma unroll
  for (int j = 0; j < OUT_PER_THREAD; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    const int r = idx / BN, c = col0 + idx % BN;
    if (c < D) out[(size_t)(row0 + r) * D + c] = from_f32<T>(y[j]);
  }
}

// Kernel 2 (weights in the input type) under kernel 4's launch bounds;
// kernel 3 (int8) capped at 128 registers a thread so that two blocks share
// an SM.
template <typename T>
__global__ void __launch_bounds__(THREADS)
up_gate_capacity_kernel(const T* __restrict__ xe, const int32_t* __restrict__ fill, int tpe,
                        const void* __restrict__ wi, const void* __restrict__ wg,
                        T* __restrict__ act, int D, int F) {
  up_gate_capacity<T, 0>(xe, fill, tpe, wi, nullptr, wg, nullptr, act, D, F);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
down_capacity_kernel(const T* __restrict__ act, const int32_t* __restrict__ fill, int tpe,
                     const void* __restrict__ wo, T* __restrict__ out, int D, int F) {
  down_capacity<T, 0>(act, fill, tpe, wo, nullptr, out, D, F);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
up_gate_capacity_int8_kernel(const T* __restrict__ xe, const int32_t* __restrict__ fill, int tpe,
                             const void* __restrict__ wi, const float* __restrict__ wi_s,
                             const void* __restrict__ wg, const float* __restrict__ wg_s,
                             T* __restrict__ act, int D, int F) {
  up_gate_capacity<T, 8>(xe, fill, tpe, wi, wi_s, wg, wg_s, act, D, F);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
down_capacity_int8_kernel(const T* __restrict__ act, const int32_t* __restrict__ fill, int tpe,
                          const void* __restrict__ wo, const float* __restrict__ wo_s,
                          T* __restrict__ out, int D, int F) {
  down_capacity<T, 8>(act, fill, tpe, wo, wo_s, out, D, F);
}

template <typename T, int BITS>
int launch(const void* xg, const void* te, const void* rows_used, const void* wi,
           const void* wi_s, const void* wg, const void* wg_s, const void* wo, const void* wo_s,
           void* act, void* out, int n_tiles, int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(THREADS);
  up_gate_kernel<T, BITS><<<dim3(n_tiles, (F + BN - 1) / BN), block, 0, s>>>(
      static_cast<const T*>(xg), static_cast<const int32_t*>(te),
      static_cast<const int32_t*>(rows_used), wi, static_cast<const float*>(wi_s), wg,
      static_cast<const float*>(wg_s), static_cast<T*>(act), D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down_kernel<T, BITS><<<dim3(n_tiles, (D + BN - 1) / BN), block, 0, s>>>(
      static_cast<const T*>(act), static_cast<const int32_t*>(te),
      static_cast<const int32_t*>(rows_used), wo, static_cast<const float*>(wo_s),
      static_cast<T*>(out), D, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_quant(const void* xg, const void* te, const void* rows_used, const void* wi,
                 const void* wi_s, const void* wg, const void* wg_s, const void* wo,
                 const void* wo_s, void* act, void* out, int n_tiles, int D, int F, int bits,
                 void* stream) {
  if (bits == 8)
    return launch<T, 8>(xg, te, rows_used, wi, wi_s, wg, wg_s, wo, wo_s, act, out, n_tiles, D, F,
                        stream);
  if (bits == 4 && D % 2 == 0 && F % 2 == 0)
    return launch<T, 4>(xg, te, rows_used, wi, wi_s, wg, wg_s, wo, wo_s, act, out, n_tiles, D, F,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int BITS>
int launch_capacity(const void* xe, const void* fill, const void* wi, const void* wi_s,
                    const void* wg, const void* wg_s, const void* wo, const void* wo_s, void* act,
                    void* out, int E, int C, int D, int F, void* stream) {
  if (E < 1 || C < TILE || C % TILE) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tpe = C / TILE;
  const dim3 up_grid(E * tpe, (F + BN - 1) / BN), down_grid(E * tpe, (D + BN - 1) / BN);
  const T* x = static_cast<const T*>(xe);
  const T* a = static_cast<const T*>(act);
  const int32_t* f = static_cast<const int32_t*>(fill);
  if constexpr (BITS == 0) {
    up_gate_capacity_kernel<T><<<up_grid, THREADS, 0, s>>>(x, f, tpe, wi, wg, static_cast<T*>(act),
                                                           D, F);
  } else {
    up_gate_capacity_int8_kernel<T><<<up_grid, THREADS, 0, s>>>(
        x, f, tpe, wi, static_cast<const float*>(wi_s), wg, static_cast<const float*>(wg_s),
        static_cast<T*>(act), D, F);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (BITS == 0) {
    down_capacity_kernel<T><<<down_grid, THREADS, 0, s>>>(a, f, tpe, wo, static_cast<T*>(out), D, F);
  } else {
    down_capacity_int8_kernel<T><<<down_grid, THREADS, 0, s>>>(
        a, f, tpe, wo, static_cast<const float*>(wo_s), static_cast<T*>(out), D, F);
  }
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
  return launch<__nv_bfloat16, 0>(xg, te, rows_used, wi, nullptr, wg, nullptr, wo, nullptr, act,
                                  out, n_tiles, D, F, stream);
}

int grouped_mlp_f32(const void* xg, const void* te, const void* rows_used, const void* wi,
                    const void* wg, const void* wo, void* act, void* out, int n_tiles, int D,
                    int F, void* stream) {
  return launch<float, 0>(xg, te, rows_used, wi, nullptr, wg, nullptr, wo, nullptr, act, out,
                          n_tiles, D, F, stream);
}

// Kernel 5: int8 (bits 8) or int4 (bits 4) weights with f32 column scales
// wi_s/wg_s [E, 1, F], wo_s [E, 1, D].
int grouped_mlp_quant_bf16(const void* xg, const void* te, const void* rows_used, const void* wi,
                           const void* wi_s, const void* wg, const void* wg_s, const void* wo,
                           const void* wo_s, void* act, void* out, int n_tiles, int D, int F,
                           int bits, void* stream) {
  return launch_quant<__nv_bfloat16>(xg, te, rows_used, wi, wi_s, wg, wg_s, wo, wo_s, act, out,
                                     n_tiles, D, F, bits, stream);
}

int grouped_mlp_quant_f32(const void* xg, const void* te, const void* rows_used, const void* wi,
                          const void* wi_s, const void* wg, const void* wg_s, const void* wo,
                          const void* wo_s, void* act, void* out, int n_tiles, int D, int F,
                          int bits, void* stream) {
  return launch_quant<float>(xg, te, rows_used, wi, wi_s, wg, wg_s, wo, wo_s, act, out, n_tiles,
                             D, F, bits, stream);
}

// Kernel 2: the capacity buffer xe [E, C, D] (C a multiple of 8), row block
// of expert e through expert e's SwiGLU MLP, weights in the input type; fill
// [E] i32 (rows at or past fill[e] hold no token); act [E*C, F] scratch and
// out [E, C, D].
int expert_mlp_bf16(const void* xe, const void* fill, const void* wi, const void* wg,
                    const void* wo, void* act, void* out, int E, int C, int D, int F,
                    void* stream) {
  return launch_capacity<__nv_bfloat16, 0>(xe, fill, wi, nullptr, wg, nullptr, wo, nullptr, act,
                                           out, E, C, D, F, stream);
}

int expert_mlp_f32(const void* xe, const void* fill, const void* wi, const void* wg,
                   const void* wo, void* act, void* out, int E, int C, int D, int F,
                   void* stream) {
  return launch_capacity<float, 0>(xe, fill, wi, nullptr, wg, nullptr, wo, nullptr, act, out, E, C,
                                   D, F, stream);
}

// Kernel 3: the same over int8 weights with f32 column scales wi_s/wg_s
// [E, 1, F], wo_s [E, 1, D].
int expert_mlp_quant_bf16(const void* xe, const void* fill, const void* wi, const void* wi_s,
                          const void* wg, const void* wg_s, const void* wo, const void* wo_s,
                          void* act, void* out, int E, int C, int D, int F, void* stream) {
  return launch_capacity<__nv_bfloat16, 8>(xe, fill, wi, wi_s, wg, wg_s, wo, wo_s, act, out, E, C,
                                           D, F, stream);
}

int expert_mlp_quant_f32(const void* xe, const void* fill, const void* wi, const void* wi_s,
                         const void* wg, const void* wg_s, const void* wo, const void* wo_s,
                         void* act, void* out, int E, int C, int D, int F, void* stream) {
  return launch_capacity<float, 8>(xe, fill, wi, wi_s, wg, wg_s, wo, wo_s, act, out, E, C, D, F,
                                   stream);
}

}  // extern "C"
