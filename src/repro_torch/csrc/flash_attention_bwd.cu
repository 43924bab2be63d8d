// The backward of flash attention (kernel 6) for Hopper, sm_90a: kernel 6b.
//
// The TPU kernel repro/kernels/flash_attention.py::flash_attention has no
// backward: JAX trains through the model's _sdpa and differentiates it with
// XLA.  The port attends through kernel 6 on every training layer, and
// autograd cannot pass through a ctypes launch, so this file computes the
// gradient jax.value_and_grad takes of the same function (the model's
// attend_full: scores scaled, softcapped, masked by positions; f32 softmax;
// probabilities rounded to v's type for P.V).  For q [B, S, H, dh], k / v
// [B, T, Hkv, dh] (G = H / Hkv query heads per kv-head), the forward's out
// O and row log-sum-exp L [B, H, S] (f32, natural log; +inf for a row with
// no valid key) and the output gradient dO:
//
//   z    = scale q.k, and with a softcap c: z = c tanh(z / c)
//   P    = exp(z - L) on valid keys, 0 elsewhere (the masks of
//          paged_attention.cuh's Mask: k_pos >= 0, causal, window)
//   D_i  = sum_d dO_i O_i                                  (delta_kernel)
//   dV_j = sum_i P_ij dO_i, P rounded to the input type as in the forward
//   dZ   = P (dO.V^T - D), times (1 - (z / c)^2) under a softcap
//   dQ   = scale dZ K,  dK = scale dZ^T Q
//
// with dK and dV summed over the G query heads of a kv-head.  A row with no
// valid key has O = 0 and gets zero gradients.
//
// Design: deterministic, no atomics, so training runs repeat bit for bit and
// card-against-CPU checks do not flake.  Three launches:
//   1. delta_kernel: D, one warp per (b, s, h) row.
//   2. dkv_kernel: one block per (b, kv-head, tile of BKT keys), holding its
//      K and V tile in shared memory (f32) and dK / dV in registers; it walks
//      the query tiles of its G heads in order, skipping a tile with no valid
//      (query, key) pair (causal frontier, window), and per tile recomputes
//      P and dZ from q, k, L and D.
//   3. dq_kernel: one block per (b, head, tile of BQT queries), holding Q,
//      dO, L and D and dQ in registers; it walks the live key tiles.
// Every product is an f32 FMA on the CUDA cores out of shared memory (tiles
// padded by one float so a warp's reads hit distinct banks), for every head
// dim the forward takes (32, 64, 112, 128, 256) and both types.  Bound: 10
// dh operations per (query head, valid pair) against the bytes of q, k, v,
// O, dO, dQ, dK and dV; the tensor cores would do these products at 989
// TFLOP/s in bf16, the CUDA cores at 67 in f32, so this first version is
// far from its bound at the training shapes: a simple kernel that is right,
// whose time PERF.md records.  (S and dP are recomputed in both 2 and 3: 14
// dh operations a pair instead of 10.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BKT = 32;  // keys per tile (one lane per key in the score step)
constexpr int BQT = 32;  // queries per tile
constexpr int NT = 256;  // threads a block
constexpr int NW = NT / 32;
constexpr int SC = BQT * BKT / NT;  // score entries a thread: rows warp + NW * e, column lane
static_assert(BKT == 32 && BQT % NW == 0, "one lane per key, whole warps per query row set");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }
// a probability rounded to the input type (the forward's P.V operand)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int* qpos;
  const int* kpos;
  const float* lse;   // [B, H, S]
  float* delta;       // [B, H, S]
  void* dq;
  void* dk;
  void* dv;
  int B, S, T, H, Hkv, G;
  paged::Mask mk;
};

template <int DH>
struct Tiles {
  float k[BKT][DH + 1];
  float v[BKT][DH + 1];
  float q[BQT][DH + 1];
  float d[BQT][DH + 1];   // dO
  float p[BQT][BKT + 1];  // P, rounded to the input type
  float ds[BQT][BKT + 1];  // dZ
  float lse[BQT];
  float delta[BQT];
  int qp[BQT];
  int kp[BKT];
};

// D = rowsum(dO * O) per (b, s, h), f32; one warp a row.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) delta_kernel(const BwdParams p) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * NW + (threadIdx.x >> 5);  // (b * S + s) * H + h
  if (row >= (size_t)p.B * p.S * p.H) return;
  const T* o = static_cast<const T*>(p.o) + row * DH;
  const T* d = static_cast<const T*>(p.dout) + row * DH;
  float acc = 0.f;
  for (int c = lane; c < DH; c += 32) acc = fmaf(ld(d + c), ld(o + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % p.H);
    const size_t bs = row / p.H;
    const int s = (int)(bs % p.S), b = (int)(bs / p.S);
    p.delta[((size_t)b * p.H + h) * p.S + s] = acc;
  }
}

// Rows [i0, i0 + nq) of head h of a [B, S, H, DH] tensor into dst (zeros past nq).
template <typename T, int DH>
__device__ __forceinline__ void stage_rows(float (*dst)[DH + 1], const T* src, int b, int i0, int nq,
                                           int S, int H, int h) {
  for (int idx = threadIdx.x; idx < BQT * DH; idx += NT) {
    const int i = idx / DH, c = idx - i * DH;
    dst[i][c] = i < nq ? ld(src + (((size_t)b * S + i0 + i) * H + h) * DH + c) : 0.f;
  }
}

// Whether some (query, key) pair of the tiles is valid: qp of nq queries,
// kp of nk keys (a barrier).
__device__ __forceinline__ bool tile_pair_live(const paged::Mask& mk, const int* qp, int nq,
                                               const int* kp, int nk) {
  bool any = false;
  for (int e = threadIdx.x; e < BQT * BKT; e += NT) {
    const int i = e / BKT, j = e - i * BKT;
    if (i < nq && j < nk) any |= mk.valid(kp[j], qp[i]);
  }
  return __syncthreads_or(any) != 0;
}

// P and dZ of the staged tiles into s.p / s.ds: thread (warp, lane) takes
// key lane and queries warp + NW e.  Ends on a barrier.
template <typename T, int DH>
__device__ __forceinline__ void scores(Tiles<DH>& s, const paged::Mask& mk, int nq, int nk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float qk[SC], dp[SC];
#pragma unroll
  for (int e = 0; e < SC; ++e) qk[e] = dp[e] = 0.f;
#pragma unroll 8
  for (int c = 0; c < DH; ++c) {
    const float kj = s.k[lane][c], vj = s.v[lane][c];
#pragma unroll
    for (int e = 0; e < SC; ++e) {
      qk[e] = fmaf(s.q[warp + NW * e][c], kj, qk[e]);
      dp[e] = fmaf(s.d[warp + NW * e][c], vj, dp[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < SC; ++e) {
    const int i = warp + NW * e;
    float pe = 0.f, dz = 0.f;
    if (i < nq && lane < nk && mk.valid(s.kp[lane], s.qp[i])) {
      float z = qk[e] * mk.scale, cap = 1.f;
      if (mk.softcap > 0.f) {
        const float t = tanhf(z / mk.softcap);
        z = t * mk.softcap;
        cap = 1.f - t * t;
      }
      pe = expf(z - s.lse[i]);
      dz = pe * (dp[e] - s.delta[i]) * cap;
    }
    s.p[i][lane] = round_to(pe, static_cast<const T*>(nullptr));
    s.ds[i][lane] = dz;
  }
  __syncthreads();
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) dkv_kernel(const BwdParams p) {
  constexpr int PER = BKT * DH / NT;  // dK / dV entries a thread: (key, column) = (e / DH, e % DH)
  static_assert(BKT * DH % NT == 0, "whole entries a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<DH>& s = *reinterpret_cast<Tiles<DH>*>(smem_raw);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * BKT, hk = blockIdx.y, b = blockIdx.z;
  const int nk = min(BKT, p.T - j0);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  for (int idx = tid; idx < BKT * DH; idx += NT) {
    const int j = idx / DH, c = idx - j * DH;
    const size_t off = (((size_t)b * p.T + j0 + j) * p.Hkv + hk) * DH + c;
    s.k[j][c] = j < nk ? ld(K + off) : 0.f;
    s.v[j][c] = j < nk ? ld(V + off) : 0.f;
  }
  if (tid < BKT) s.kp[tid] = tid < nk ? p.kpos[(size_t)b * p.T + j0 + tid] : -1;
  float dk[PER], dv[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) dk[e] = dv[e] = 0.f;
  __syncthreads();
  for (int g = 0; g < p.G; ++g) {
    const int h = hk * p.G + g;
    for (int i0 = 0; i0 < p.S; i0 += BQT) {
      const int nq = min(BQT, p.S - i0);
      if (tid < BQT) s.qp[tid] = tid < nq ? p.qpos[(size_t)b * p.S + i0 + tid] : 0;
      __syncthreads();
      if (!tile_pair_live(p.mk, s.qp, nq, s.kp, nk)) continue;
      stage_rows<T, DH>(s.q, static_cast<const T*>(p.q), b, i0, nq, p.S, p.H, h);
      stage_rows<T, DH>(s.d, static_cast<const T*>(p.dout), b, i0, nq, p.S, p.H, h);
      if (tid < BQT) {
        const size_t r = ((size_t)b * p.H + h) * p.S + i0 + tid;
        s.lse[tid] = tid < nq ? p.lse[r] : INFINITY;
        s.delta[tid] = tid < nq ? p.delta[r] : 0.f;
      }
      __syncthreads();
      scores<T, DH>(s, p.mk, nq, nk);
#pragma unroll 4
      for (int i = 0; i < BQT; ++i) {
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          const int idx = tid + e * NT, j = idx / DH, c = idx - j * DH;
          dv[e] = fmaf(s.p[i][j], s.d[i][c], dv[e]);
          dk[e] = fmaf(s.ds[i][j], s.q[i][c], dk[e]);
        }
      }
      __syncthreads();  // the tiles are consumed before the next is staged
    }
  }
  T* dK = static_cast<T*>(p.dk);
  T* dV = static_cast<T*>(p.dv);
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = tid + e * NT, j = idx / DH, c = idx - j * DH;
    if (j < nk) {
      const size_t off = (((size_t)b * p.T + j0 + j) * p.Hkv + hk) * DH + c;
      st(dK + off, dk[e] * p.mk.scale);
      st(dV + off, dv[e]);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) dq_kernel(const BwdParams p) {
  constexpr int PER = BQT * DH / NT;  // dQ entries a thread: (query, column) = (e / DH, e % DH)
  static_assert(BQT * DH % NT == 0, "whole entries a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<DH>& s = *reinterpret_cast<Tiles<DH>*>(smem_raw);
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BQT, h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const int nq = min(BQT, p.S - i0);
  const T* K = static_cast<const T*>(p.k);
  const T* V = static_cast<const T*>(p.v);
  stage_rows<T, DH>(s.q, static_cast<const T*>(p.q), b, i0, nq, p.S, p.H, h);
  stage_rows<T, DH>(s.d, static_cast<const T*>(p.dout), b, i0, nq, p.S, p.H, h);
  if (tid < BQT) {
    const size_t r = ((size_t)b * p.H + h) * p.S + i0 + tid;
    s.qp[tid] = tid < nq ? p.qpos[(size_t)b * p.S + i0 + tid] : 0;
    s.lse[tid] = tid < nq ? p.lse[r] : INFINITY;
    s.delta[tid] = tid < nq ? p.delta[r] : 0.f;
  }
  float dq[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) dq[e] = 0.f;
  for (int j0 = 0; j0 < p.T; j0 += BKT) {
    const int nk = min(BKT, p.T - j0);
    __syncthreads();  // the last tile is consumed (and, first, the rows are staged)
    if (tid < BKT) s.kp[tid] = tid < nk ? p.kpos[(size_t)b * p.T + j0 + tid] : -1;
    __syncthreads();
    if (!tile_pair_live(p.mk, s.qp, nq, s.kp, nk)) continue;
    for (int idx = tid; idx < BKT * DH; idx += NT) {
      const int j = idx / DH, c = idx - j * DH;
      const size_t off = (((size_t)b * p.T + j0 + j) * p.Hkv + hk) * DH + c;
      s.k[j][c] = j < nk ? ld(K + off) : 0.f;
      s.v[j][c] = j < nk ? ld(V + off) : 0.f;
    }
    __syncthreads();
    scores<T, DH>(s, p.mk, nq, nk);
#pragma unroll 4
    for (int j = 0; j < BKT; ++j) {
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int idx = tid + e * NT, i = idx / DH, c = idx - i * DH;
        dq[e] = fmaf(s.ds[i][j], s.k[j][c], dq[e]);
      }
    }
  }
  T* dQ = static_cast<T*>(p.dq);
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int idx = tid + e * NT, i = idx / DH, c = idx - i * DH;
    if (i < nq) st(dQ + (((size_t)b * p.S + i0 + i) * p.H + h) * DH + c, dq[e] * p.mk.scale);
  }
}

template <typename T, int DH>
int launch(const BwdParams& p, cudaStream_t stream) {
  const int smem = (int)sizeof(Tiles<DH>);
  static const cudaError_t a1 =
      cudaFuncSetAttribute(dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t a2 =
      cudaFuncSetAttribute(dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const size_t rows = (size_t)p.B * p.S * p.H;
  delta_kernel<T, DH><<<(unsigned)((rows + NW - 1) / NW), NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<T, DH><<<dim3((p.T + BKT - 1) / BKT, p.Hkv, p.B), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, DH><<<dim3((p.S + BQT - 1) / BQT, p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const BwdParams& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 112: return launch<T, 112>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Device pointers of contiguous
// tensors: q, o, dout [B, S, H, dh], k, v [B, T, Hkv, dh] in one type (bf16:
// is_bf16 = 1, else f32), qpos [B, S] and kpos [B, T] int32, lse [B, H, S]
// f32 in; delta [B, H, S] f32 scratch, dq, dk, dv (shapes of q, k, v) out,
// allocated by the caller.  stream is a cudaStream_t.  Returns
// cudaGetLastError() after the launches (0 = success), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v, const void* o,
                                        const void* dout, const void* qpos, const void* kpos,
                                        const void* lse, void* delta, void* dq, void* dk, void* dv,
                                        int B, int S, int T, int H, int Hkv, int dh, int is_bf16,
                                        float scale, int causal, int window, float softcap,
                                        void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || S > 65535 * BQT || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, o, dout, static_cast<const int*>(qpos), static_cast<const int*>(kpos),
              static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
              B, S, T, H, Hkv, H / Hkv, paged::Mask{scale, softcap, causal, window}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(p, dh, st) : dispatch<float>(p, dh, st);
}
