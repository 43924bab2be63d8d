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
// Design: deterministic, no atomics in any sum, so training runs repeat bit
// for bit and card-against-CPU checks do not flake.  Three passes, each a
// launch: a D pass, a dK / dV pass over key tiles and a dQ pass over query
// tiles (S and dP are recomputed in both: 14 dh operations a pair instead
// of 10).
//
// bf16 (training at every head dim the forward takes: 32, 64, 112, 128,
// 256): the tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate), with
// fragments from ldmatrix (.trans) over bf16 tiles in shared memory, rows
// padded by 16 bytes so the 8 row addresses of each matrix fall on distinct
// banks (mma_sm90.cuh).  Tiles of BT = 64 keys and 64 queries, four warps
// of 16 rows each.
//   1. delta_bf16_kernel: D, 16 bytes of O and dO a lane, a (b, s, h) row
//      on the fewest lanes (a power of two) that cover it.
//   2. dkv_mma_kernel, FlashAttention-2's transposed orientation: a block
//      per (b, kv-head, 64-key tile[, head split]) holds K and V in shared
//      memory; each warp owns 16 keys and computes S^T = K Q^T and
//      dP^T = V dO^T into accumulators, forms P^T = exp(z - L) and
//      dS^T = P^T (dP^T - D) (times the softcap's factor) there, with L
//      and D read per query column from shared memory, and re-packs both in
//      registers as the A operand of dV += P^T dO and dK += dS^T Q (dO and
//      Q through ldmatrix .trans), the way the forward feeds P to P.V:
//      neither matrix goes through shared memory.  dK and dV stay in
//      registers across the walk over the G heads' query tiles, whose next
//      tile (Q, dO, L, D, positions) is staged with cp.async, double
//      buffered, while the warps compute on the current one.
//   3. dq_mma_kernel: a block per (b, head, 64-query tile), each warp 16
//      queries: S = Q K^T, dP = dO V^T, dS in registers, then dQ += dS K
//      with K through ldmatrix .trans; the next live K / V tile is staged
//      with cp.async, double buffered.
// Rounding: P is rounded to bf16 for dV, because that is the forward's P.V
// operand; dS is rounded to bf16 as the A operand of the dK and dQ products
// (FlashAttention-2 and -3 do the same).  Sums are f32.  The f32 plain
// version (kernels/flash_attention.py) holds the kernel per row.
// Tile marks instead of a per-pair scan: the dQ pass marks, from the key
// positions of its batch row, the key tiles that may hold a key valid for
// one of its queries and those whose every pair is valid
// (sm90::mark_tiles, as the forward does): dead tiles are never loaded,
// full tiles take no per-entry mask.  The dK / dV pass marks the mirror,
// query tiles against the valid-key range of its key tile
// (mark_query_tiles; kernels/flash_attention.py::query_tile_marks is the
// rule in PyTorch): on a causal row its walk starts at the first query
// tile that can see the key tile.
// Head dim 256: dK and dV of 16 keys x 256 columns (256 f32 accumulators)
// do not fit a warp's registers beside S and dP, so the columns are split
// across warps: 8 warps, two on each 16 rows, each accumulating 128 of the
// columns (of dK / dV, and of dQ) and both computing their rows' S and dP.
// The dK / dV pass scores 32 query columns at a time, and both passes
// reload the fixed tile's A fragments by ldmatrix at each k-step (no
// registers held across the walk), at every head dim.
// Small grids: where the dK / dV grid (key tiles x Hkv x B) is below the SM
// count, the G query heads of a kv-head are split across blocks
// (kernels/flash_attention.py::backward_head_splits); each block writes f32
// partials of dK and dV into a workspace the wrapper allocates, and
// sum_splits_kernel adds them in split order: still deterministic.
// Both passes issue the heaviest blocks first: the tile index is the
// grid's slowest dimension (a causal row's first key tile, its last query
// tile), so no heavy block starts last and leaves a tail.  The softmax step
// is branch-free (a select per masked entry; none on a full tile; the
// softcap an instance of its own), and a thread's tile loads step by a
// fixed row stride.
// A row with no valid key has L = +inf, hence P = 0 and zero gradients;
// rows past S and keys past T are zero-filled (L = +inf past S; keys past
// T are masked and never stored).
//
// f32 (the reduced card-against-CPU checks): the first version of this kernel, every
// product an f32 FMA on the CUDA cores out of shared memory (tiles padded
// by one float so a warp's reads hit distinct banks): dkv_kernel, one block
// per (b, kv-head, 32-key tile), walks the query tiles of its G heads,
// skipping a tile with no valid pair; dq_kernel, one block per (b, head,
// 32-query tile), walks the live key tiles.
//
// Bound: 10 dh operations per (query head, valid pair) against the bytes of
// q, k, v, O, dO, dQ, dK, dV, L and the positions; at the training shapes
// the tensor cores (989 TFLOP/s bf16) or the bytes, whichever is larger
// (launch/training_kernels.py prints both).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "paged_attention.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int BKT = 32;  // keys per tile (one lane per key in the score step)
constexpr int BQT = 32;  // queries per tile
constexpr int NT = 256;  // threads a block
constexpr int NW = NT / 32;
constexpr int SC = BQT * BKT / NT;  // score entries a thread: rows warp + NW * e, column lane
static_assert(BKT == 32 && BQT % NW == 0, "one lane per key, whole warps per query row set");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
// a probability rounded to the input type (the forward's P.V operand; f32 here)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

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

// Lanes of the bf16 D pass a (b, s, h) row: the power of two at or above
// dh / 8 (16 bytes a lane), at least 4.
__host__ __device__ constexpr int delta_lanes(int dh) {
  return dh / 8 <= 4 ? 4 : dh / 8 <= 8 ? 8 : dh / 8 <= 16 ? 16 : 32;
}

// D for bf16, 16 bytes a lane: LPR lanes a row, 32 / LPR rows a warp, 8
// warps a block.
template <int DH>
__global__ void __launch_bounds__(NT) delta_bf16_kernel(const BwdParams p) {
  constexpr int CH = DH / 8, LPR = delta_lanes(DH), RPW = 32 / LPR;
  static_assert(CH <= 32, "one 16-byte chunk a lane");
  const int lane = threadIdx.x & 31, sub = lane % LPR;
  const size_t row = ((size_t)blockIdx.x * NW + (threadIdx.x >> 5)) * RPW + lane / LPR;
  const bool in = row < (size_t)p.B * p.S * p.H;
  float acc = 0.f;
  if (in && sub < CH) {
    const uint4 o = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.o) + row * DH + sub * 8);
    const uint4 d =
        *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p.dout) + row * DH + sub * 8);
    const uint32_t ow[4] = {o.x, o.y, o.z, o.w}, dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[w]));
      const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[w]));
      acc = fmaf(df.x, of.x, acc);
      acc = fmaf(df.y, of.y, acc);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && sub == 0) {
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int BT = 64;               // keys per key tile, queries per query tile
constexpr int MAX_TILE_WORDS = 128;  // tile bitmasks: up to 128 * 32 tiles of BT (MAX_KEYS)
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct MmaCfg {
  static constexpr int CS = DH > 128 ? 2 : 1;        // warps on each 16 rows (column slices)
  static constexpr int NWARP = 4 * CS;
  static constexpr int NT = 32 * NWARP;
  static constexpr int DC = DH / CS;                 // dK / dV / dQ columns a warp accumulates
  static constexpr int LD = DH + 8;                  // padded bf16 row: ldmatrix rows on distinct banks
  static constexpr int KS = DH / 16;                 // k-steps over dh
  static constexpr int QH = BT / 2;                  // query columns a dK / dV score step takes
  static_assert(DH % 16 == 0 && DC % 16 == 0, "whole k-steps and column pairs");
};

template <int DH>
struct DkvSmem {
  static constexpr int LD = MmaCfg<DH>::LD;
  bf16 k[BT][LD];
  bf16 v[BT][LD];
  bf16 q[2][BT][LD];
  bf16 d[2][BT][LD];  // dO
  float lse[2][BT];
  float delta[2][BT];
  int qp[2][BT];
  int kp[BT];                     // the key tile's positions, -1 past T
  unsigned live[MAX_TILE_WORDS];  // query tiles with a valid pair for some key of the tile
  unsigned full[MAX_TILE_WORDS];  // query tiles whose every pair with the tile's keys is valid
  int klo, khi, kn;               // the tile's valid key positions: range and count
};

template <int DH>
struct DqSmem {
  static constexpr int LD = MmaCfg<DH>::LD;
  bf16 q[BT][LD];
  bf16 d[BT][LD];  // dO
  bf16 k[2][BT][LD];
  bf16 v[2][BT][LD];
  int kp[2][BT];  // key positions of a tile, -1 past T
  int qp[BT];
  float lse[BT];
  float delta[BT];
  unsigned live[MAX_TILE_WORDS];  // key tiles that may hold a key valid for some query
  unsigned full[MAX_TILE_WORDS];  // key tiles whose every key is valid for every query
  int qp_lo, qp_hi;
};

// Rows r0 .. r0 + BT - 1 (zero past n) of one head of a [B, n, heads, DH]
// bf16 tensor, row r at row0 + r * heads * DH, into a padded [BT][LD] tile
// with cp.async, two tensors at once (q and dO, or k and v).  Where the
// block's threads divide the rows' 16-byte chunks evenly, a thread's chunks
// step by a fixed number of rows (no index arithmetic per chunk).
template <int DH, int LD, int NTH>
__device__ __forceinline__ void load_tile2(bf16 (*da)[LD], bf16 (*db)[LD], const bf16* A,
                                           const bf16* B, size_t row0, int r0, int n, int heads) {
  constexpr int CH = DH / 8;
  const int tid = threadIdx.x;
  if constexpr (NTH % CH == 0) {
    constexpr int RSTEP = NTH / CH;
    const int r = tid / CH, c = (tid - r * CH) * 8;
    const size_t base = row0 + ((size_t)r * heads) * DH + c, step = (size_t)RSTEP * heads * DH;
#pragma unroll
    for (int k = 0; k < BT / RSTEP; ++k) {
      const bool ok = r0 + r + k * RSTEP < n;
      const size_t off = ok ? base + k * step : 0;
      cp_async16(&da[r + k * RSTEP][c], A + off, ok);
      cp_async16(&db[r + k * RSTEP][c], B + off, ok);
    }
  } else {
    for (int i = tid; i < BT * CH; i += NTH) {
      const int r = i / CH, c = (i - r * CH) * 8;
      const bool ok = r0 + r < n;
      const size_t off = ok ? row0 + ((size_t)r * heads) * DH + c : 0;
      cp_async16(&da[r][c], A + off, ok);
      cp_async16(&db[r][c], B + off, ok);
    }
  }
}

// The mirror of sm90::mark_tiles for the dK / dV pass.  Among the
// ceil(S / BT) query tiles of a batch row's positions qpos[0 .. S), mark
// those that may hold a query with a valid pair for some valid key of a key
// tile whose kn valid positions span [klo, khi] (live: causal qp >= klo,
// window qp - khi < window; none when kn = 0), and those whose every query
// pairs validly with every key of the tile (full: all BT keys valid, causal
// qp >= khi, window qp - klo < window), query by query; queries past S do
// not count.  kernels/flash_attention.py::query_tile_marks is the same rule
// in PyTorch.  Every thread of the block calls it; it ends on a barrier.
__device__ void mark_query_tiles(const int* __restrict__ qpos, int S, int klo, int khi, int kn,
                                 const paged::Mask& mk, unsigned* live, unsigned* full) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int nQ = (S + BT - 1) / BT;
  for (int w = threadIdx.x; w < (nQ + 31) >> 5; w += blockDim.x) live[w] = full[w] = 0u;
  __syncthreads();
  if (kn > 0) {
    for (int t = warp; t < nQ; t += nw) {
      bool may = false, all = true;
#pragma unroll
      for (int u = 0; u < BT / 32; ++u) {
        const int i = t * BT + u * 32 + lane;
        if (i < S) {
          const int qp = __ldg(qpos + i);
          may |= (!mk.causal || qp >= klo) && (mk.window <= 0 || qp - khi < mk.window);
          all &= (!mk.causal || qp >= khi) && (mk.window <= 0 || qp - klo < mk.window);
        }
      }
      may = __any_sync(0xffffffffu, may);
      all = __all_sync(0xffffffffu, all) && kn == BT;
      if (lane == 0 && may) atomicOr(&live[t >> 5], 1u << (t & 31));
      if (lane == 0 && all) atomicOr(&full[t >> 5], 1u << (t & 31));
    }
  }
  __syncthreads();
}

// 2^x, approximate (relative error about 2^-22); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Whether a (key, query) pair is valid under the masks of paged::Mask,
// without branches (a select per entry, so the compiler interleaves the
// entries of a tile).
__device__ __forceinline__ bool pair_ok(const paged::Mask& mk, int kp, int qp) {
  return (kp >= 0) & (!mk.causal | (kp <= qp)) & ((mk.window <= 0) | (qp - kp < mk.window));
}

// P and dS of one score entry from its raw product qk and dO.V product dp,
// given its row's -L log2 e (nl2) and D: P = 2^(z log2 e - L log2 e) on a
// valid pair (MASKED: the pair is tested; a full tile's are all valid),
// else 0; dS = P (dp - D), times 1 - (z / c)^2 under a softcap c (CAP).
// Each is an instance of its own, so a tile's loop has no branch.
template <bool CAP, bool MASKED>
__device__ __forceinline__ void p_ds(const paged::Mask& mk, int kp, int qp, float qk, float dp,
                                     float nl2, float d, float& pe, float& ds) {
  float zl, cap = 1.f;
  if constexpr (CAP) {
    const float th = tanhf(qk * mk.scale / mk.softcap);
    zl = fmaf(th, mk.softcap * LOG2E, nl2);
    cap = 1.f - th * th;
  } else {
    zl = fmaf(qk, mk.scale * LOG2E, nl2);
  }
  pe = ex2(zl);
  if constexpr (MASKED) pe = pair_ok(mk, kp, qp) ? pe : 0.f;
  ds = CAP ? pe * (dp - d) * cap : pe * (dp - d);
}

// The A fragment of a 16 x 16 k-step from two 16 x 8 accumulator tiles, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// dK / dV: one block per (kv-head x split, batch row, key tile), the key
// tile slowest, so every block of the first key tile (a causal row's
// heaviest: every query tile sees it) is issued first.  splits = 1:
// dK (scaled) and dV in bf16 into p.dk / p.dv; else f32 partials into
// part[2][splits][B, T, Hkv, DH] (dK scaled), summed by sum_splits_kernel.
// CAP: the softcap instance.
template <int DH, bool CAP>
__global__ void __launch_bounds__(MmaCfg<DH>::NT) dkv_mma_kernel(const BwdParams p, int splits,
                                                                 float* part) {
  using C = MmaCfg<DH>;
  using Sm = DkvSmem<DH>;
  constexpr int KS = C::KS, NQ = C::QH / 8, NC = C::DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp & 3, cs = warp >> 2;  // this warp's 16 keys, and its column slice
  const int j0 = blockIdx.z * BT, b = blockIdx.y;
  const int hk = blockIdx.x / splits, sp = blockIdx.x - hk * splits;
  const int g0 = sp * p.G / splits, g1 = (sp + 1) * p.G / splits;
  const bf16* Q = static_cast<const bf16*>(p.q);
  const bf16* K = static_cast<const bf16*>(p.k);
  const bf16* V = static_cast<const bf16*>(p.v);
  const bf16* dO = static_cast<const bf16*>(p.dout);
  const int nQT = (p.S + BT - 1) / BT;

  // the key tile (zero past T) and its positions (-1 past T)
  load_tile2<DH, C::LD, C::NT>(s.k, s.v, K, V, (((size_t)b * p.T + j0) * p.Hkv + hk) * DH, j0, p.T,
                               p.Hkv);
  cp_async_commit();
  if (tid < BT) s.kp[tid] = j0 + tid < p.T ? __ldg(p.kpos + (size_t)b * p.T + j0 + tid) : -1;
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN, n = 0;
    for (int e = lane; e < BT; e += 32) {
      const int kp = s.kp[e];
      if (kp >= 0) {
        lo = min(lo, kp);
        hi = max(hi, kp);
        ++n;
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) {
      s.klo = lo;
      s.khi = hi;
      s.kn = n;
    }
  }
  __syncthreads();
  mark_query_tiles(p.qpos + (size_t)b * p.S, p.S, s.klo, s.khi, s.kn, p.mk, s.live, s.full);

  // query tile t of head g (rows past S zero, L = +inf) into buffer buf
  auto load_q = [&](int g, int t, int buf) {
    const int h = hk * p.G + g, i0 = t * BT;
    load_tile2<DH, C::LD, C::NT>(s.q[buf], s.d[buf], Q, dO, (((size_t)b * p.S + i0) * p.H + h) * DH,
                                 i0, p.S, p.H);
    if (tid < BT) {
      const int sq = i0 + tid;
      if (sq < p.S) {
        const size_t row = ((size_t)b * p.H + h) * p.S + sq;
        cp_async4(&s.lse[buf][tid], p.lse + row);
        cp_async4(&s.delta[buf][tid], p.delta + row);
        cp_async4(&s.qp[buf][tid], p.qpos + (size_t)b * p.S + sq);
      } else {
        s.lse[buf][tid] = INFINITY;
        s.delta[buf][tid] = 0.f;
        s.qp[buf][tid] = 0;
      }
    }
    cp_async_commit();
  };

  // the walk: (head g, live query tile t), heads in order (every head has
  // the same marks: they depend on positions only)
  int g = g0, t = next_live(s.live, 0, nQT);
  if (t >= nQT) g = g1;  // no query sees this key tile: dK = dV = 0
  if (g < g1) load_q(g, t, 0);
  cp_async_wait_all();  // K, V and the first query tile
  __syncthreads();

  const int kr = kw * 16 + (lane >> 2);  // this thread's keys: kr and kr + 8
  const int kpr[2] = {s.kp[kr], s.kp[kr + 8]};
  const int c0 = (lane & 3) * 2;  // this thread's first column of an 8-wide tile
  float dk[NC][4] = {}, dv[NC][4] = {};

  int buf = 0;
  while (g < g1) {
    int gn = g, tn = next_live(s.live, t + 1, nQT);
    if (tn >= nQT) {
      ++gn;
      tn = next_live(s.live, 0, nQT);
    }
    if (gn < g1) load_q(gn, tn, buf ^ 1);  // released by the barrier that ended the last tile
    const bool all = (s.full[t >> 5] >> (t & 31)) & 1u;
#pragma unroll
    for (int sub = 0; sub < BT; sub += C::QH) {
      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x QH queries
      float st[NQ][4] = {}, dpt[NQ][4] = {};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, &s.k[kw * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
        ldmatrix_x4(va, &s.v[kw * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int rr = sub + np * 16 + (lane >> 4) * 8 + (lane & 7);
          const int cc = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t qb[4], db[4];
          ldmatrix_x4(qb, &s.q[buf][rr][cc]);
          mma_bf16(st[2 * np], ka, qb[0], qb[1]);
          mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
          ldmatrix_x4(db, &s.d[buf][rr][cc]);
          mma_bf16(dpt[2 * np], va, db[0], db[1]);
          mma_bf16(dpt[2 * np + 1], va, db[2], db[3]);
        }
      }
      // P^T = exp(z - L) and dS^T = P^T (dP^T - D) cap, per query column;
      // a full tile takes no mask
      auto p_ds_tile = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = sub + n * 8 + c0 + c, qp = s.qp[buf][col];
            const float nl2 = -s.lse[buf][col] * LOG2E, d = s.delta[buf][col];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 2 * i + c;
              p_ds<CAP, decltype(masked)::value>(p.mk, kpr[i], qp, st[n][e], dpt[n][e], nl2, d,
                                                 st[n][e], dpt[n][e]);
            }
          }
        }
      };
      if (all)
        p_ds_tile(std::false_type());
      else
        p_ds_tile(std::true_type());
      // dV += P^T dO and dK += dS^T Q, P^T and dS^T as A fragments in registers
#pragma unroll
      for (int kk = 0; kk < NQ / 2; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
        const int rr = sub + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dp = 0; dp < NC / 2; ++dp) {
          const int cc = cs * C::DC + dp * 16 + (lane >> 4) * 8;
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, &s.d[buf][rr][cc]);
          mma_bf16(dv[2 * dp], pa, ob[0], ob[1]);
          mma_bf16(dv[2 * dp + 1], pa, ob[2], ob[3]);
          ldmatrix_x4_trans(qb, &s.q[buf][rr][cc]);
          mma_bf16(dk[2 * dp], sa, qb[0], qb[1]);
          mma_bf16(dk[2 * dp + 1], sa, qb[2], qb[3]);
        }
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... for every thread, and this one is consumed
    buf ^= 1;
    g = gn;
    t = tn;
  }

  // store: rows kr, kr + 8; columns cs DC + 8 n + c0, + 1
  const float scale = p.mk.scale;
  const size_t nkv = (size_t)p.B * p.T * p.Hkv * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t_ = j0 + kr + 8 * i;
    if (t_ >= p.T) continue;
    const size_t row = (((size_t)b * p.T + t_) * p.Hkv + hk) * DH + cs * C::DC + c0;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const float k0 = dk[n][2 * i] * scale, k1 = dk[n][2 * i + 1] * scale;
      const float v0 = dv[n][2 * i], v1 = dv[n][2 * i + 1];
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dk) + row + n * 8) = pack_bf16(k0, k1);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dv) + row + n * 8) = pack_bf16(v0, v1);
      } else {
        *reinterpret_cast<float2*>(part + sp * nkv + row + n * 8) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(part + (splits + sp) * nkv + row + n * 8) = make_float2(v0, v1);
      }
    }
  }
}

// dK and dV from the f32 partials of the head splits, summed in split
// order (deterministic), four values a thread.  n = B * T * Hkv * DH.
__global__ void __launch_bounds__(256) sum_splits_kernel(const float* __restrict__ part, bf16* dk,
                                                         bf16* dv, size_t n, int splits) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;  // of 2 n
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const size_t e = is_v ? i - n : i;
  const float* src = part + (is_v ? (size_t)splits * n : 0) + e;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int sp = 1; sp < splits; ++sp) {
    const float4 x = *reinterpret_cast<const float4*>(src + sp * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  bf16* dst = (is_v ? dv : dk) + e;
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}

// dQ: one block per (head, batch row, query tile), the query tile slowest
// and the heaviest causal tiles (the last) first.  CAP: the softcap
// instance.
template <int DH, bool CAP>
__global__ void __launch_bounds__(MmaCfg<DH>::NT) dq_mma_kernel(const BwdParams p) {
  using C = MmaCfg<DH>;
  using Sm = DqSmem<DH>;
  constexpr int KS = C::KS, NS = BT / 8, NC = C::DC / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qw = warp & 3, cs = warp >> 2;  // this warp's 16 queries, and its column slice
  const int i0 = (gridDim.z - 1 - blockIdx.z) * BT, h = blockIdx.x, b = blockIdx.y, hk = h / p.G;
  const int nT = (p.T + BT - 1) / BT;
  const bf16* Q = static_cast<const bf16*>(p.q);
  const bf16* K = static_cast<const bf16*>(p.k);
  const bf16* V = static_cast<const bf16*>(p.v);
  const bf16* dO = static_cast<const bf16*>(p.dout);
  const int* kpos = p.kpos + (size_t)b * p.T;

  // the query tile and dO (zero past S), positions, L (+inf past S) and D
  load_tile2<DH, C::LD, C::NT>(s.q, s.d, Q, dO, (((size_t)b * p.S + i0) * p.H + h) * DH, i0, p.S,
                               p.H);
  cp_async_commit();
  if (tid < BT) {
    const int sq = i0 + tid;
    const size_t row = ((size_t)b * p.H + h) * p.S + sq;
    s.qp[tid] = sq < p.S ? __ldg(p.qpos + (size_t)b * p.S + sq) : 0;
    s.lse[tid] = sq < p.S ? __ldg(p.lse + row) : INFINITY;
    s.delta[tid] = sq < p.S ? __ldg(p.delta + row) : 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < BT && i0 + r < p.S; r += 32) {
      lo = min(lo, s.qp[r]);
      hi = max(hi, s.qp[r]);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      s.qp_lo = lo;
      s.qp_hi = hi;
    }
  }
  __syncthreads();
  // the key tiles that may hold a key valid for some query, and the full ones
  mark_tiles<BT, 16>(kpos, p.T, s.qp_lo, s.qp_hi, p.mk.causal, p.mk.window, s.live, s.full,
                     MAX_TILE_WORDS);

  auto load_kv = [&](int j, int buf) {
    const int t0 = j * BT;
    load_tile2<DH, C::LD, C::NT>(s.k[buf], s.v[buf], K, V, (((size_t)b * p.T + t0) * p.Hkv + hk) * DH,
                                 t0, p.T, p.Hkv);
    if (tid < BT) {
      if (t0 + tid < p.T)
        cp_async4(&s.kp[buf][tid], kpos + t0 + tid);
      else
        s.kp[buf][tid] = -1;
    }
    cp_async_commit();
  };

  int j = next_live(s.live, 0, nT);
  if (j < nT) load_kv(j, 0);
  cp_async_wait_all();
  __syncthreads();

  const int qr = qw * 16 + (lane >> 2);  // this thread's queries: qr and qr + 8
  const int qpr[2] = {s.qp[qr], s.qp[qr + 8]};
  const float nl2[2] = {-s.lse[qr] * LOG2E, -s.lse[qr + 8] * LOG2E};  // -L, log2 domain
  const float dr[2] = {s.delta[qr], s.delta[qr + 8]};
  const int c0 = (lane & 3) * 2;
  float dq[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int buf = 0;
  while (j < nT) {
    const int jn = next_live(s.live, j + 1, nT);
    if (jn < nT) load_kv(jn, buf ^ 1);  // released by the barrier that ended the last tile
    const bool all = (s.full[j >> 5] >> (j & 31)) & 1u;
    // S = Q K^T and dP = dO V^T: the warp's 16 queries x 64 keys
    float sc[NS][4] = {}, dps[NS][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, &s.q[qw * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
      ldmatrix_x4(da, &s.d[qw * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        const int rr = np * 16 + (lane >> 4) * 8 + (lane & 7), cc = kk * 16 + ((lane >> 3) & 1) * 8;
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, &s.k[buf][rr][cc]);
        mma_bf16(sc[2 * np], qa, kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qa, kb[2], kb[3]);
        ldmatrix_x4(vb, &s.v[buf][rr][cc]);
        mma_bf16(dps[2 * np], da, vb[0], vb[1]);
        mma_bf16(dps[2 * np + 1], da, vb[2], vb[3]);
      }
    }
    // dS = P (dP - D) cap with P = exp(z - L), per key column; a full tile
    // takes no mask
    auto ds_tile = [&](auto masked) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = s.kp[buf][n * 8 + c0 + c];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + c;
            float pe;
            p_ds<CAP, decltype(masked)::value>(p.mk, kp, qpr[i], sc[n][e], dps[n][e], nl2[i], dr[i],
                                               pe, dps[n][e]);
          }
        }
      }
    };
    if (all)
      ds_tile(std::false_type());
    else
      ds_tile(std::true_type());
    // dQ += dS K, dS as A fragments in registers, K through ldmatrix .trans
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t sa[4];
      acc_to_a(sa, dps[2 * kk], dps[2 * kk + 1]);
      const int rr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < NC / 2; ++dp) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, &s.k[buf][rr][cs * C::DC + dp * 16 + (lane >> 4) * 8]);
        mma_bf16(dq[2 * dp], sa, kb[0], kb[1]);
        mma_bf16(dq[2 * dp + 1], sa, kb[2], kb[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... for every thread, and this one is consumed
    buf ^= 1;
    j = jn;
  }

  bf16* dQ = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int sq = i0 + qr + 8 * i;
    if (sq >= p.S) continue;
    bf16* row = dQ + (((size_t)b * p.S + sq) * p.H + h) * DH + cs * C::DC + c0;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) =
          pack_bf16(dq[n][2 * i] * p.mk.scale, dq[n][2 * i + 1] * p.mk.scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Every pass's grid, in one place: the launches take theirs from here, and
// flash_attention_backward_blocks reports them.  sum: the sum of the head
// splits' partials (bf16 with splits > 1; x = 0 where it is not launched).
struct Grids {
  dim3 delta, dkv, sum, dq;
};

Grids grids(const BwdParams& p, int dh, bool bf16_in, int splits) {
  const size_t rows = (size_t)p.B * p.S * p.H;
  if (!bf16_in)
    return {dim3((unsigned)((rows + NW - 1) / NW)), dim3((p.T + BKT - 1) / BKT, p.Hkv, p.B), dim3(0),
            dim3((p.S + BQT - 1) / BQT, p.H, p.B)};
  const size_t rpb = NW * 32 / delta_lanes(dh), n = (size_t)p.B * p.T * p.Hkv * dh;
  return {dim3((unsigned)((rows + rpb - 1) / rpb)), dim3(p.Hkv * splits, p.B, (p.T + BT - 1) / BT),
          dim3(splits > 1 ? (unsigned)((2 * n / 4 + 255) / 256) : 0u),
          dim3(p.H, p.B, (p.S + BT - 1) / BT)};
}

template <int DH>
int launch_f32(const BwdParams& p, cudaStream_t stream) {
  const int smem = (int)sizeof(Tiles<DH>);
  static const cudaError_t a1 =
      cudaFuncSetAttribute(dkv_kernel<float, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  static const cudaError_t a2 =
      cudaFuncSetAttribute(dq_kernel<float, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const Grids g = grids(p, DH, false, 1);
  delta_kernel<float, DH><<<g.delta, NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<float, DH><<<g.dkv, NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<float, DH><<<g.dq, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH, bool CAP>
int launch_bf16_instance(const BwdParams& p, int splits, float* part, cudaStream_t stream) {
  using C = MmaCfg<DH>;
  const int s_kv = (int)sizeof(DkvSmem<DH>), s_q = (int)sizeof(DqSmem<DH>);
  static const cudaError_t a1 = cudaFuncSetAttribute(
      dkv_mma_kernel<DH, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, s_kv);
  static const cudaError_t a2 = cudaFuncSetAttribute(
      dq_mma_kernel<DH, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, s_q);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const Grids g = grids(p, DH, true, splits);
  delta_bf16_kernel<DH><<<g.delta, NT, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_mma_kernel<DH, CAP><<<g.dkv, C::NT, s_kv, stream>>>(p, splits, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    sum_splits_kernel<<<g.sum, 256, 0, stream>>>(part, static_cast<bf16*>(p.dk),
                                                 static_cast<bf16*>(p.dv),
                                                 (size_t)p.B * p.T * p.Hkv * DH, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  dq_mma_kernel<DH, CAP><<<g.dq, C::NT, s_q, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
int launch_bf16(const BwdParams& p, int splits, float* part, cudaStream_t stream) {
  return p.mk.softcap > 0.f ? launch_bf16_instance<DH, true>(p, splits, part, stream)
                            : launch_bf16_instance<DH, false>(p, splits, part, stream);
}

bool head_dim_ok(int dh) { return dh == 32 || dh == 64 || dh == 112 || dh == 128 || dh == 256; }

// The shapes the launches take (splits: bf16 only, 1 .. G).
bool shapes_ok(int B, int S, int T, int H, int Hkv, int dh, bool bf16_in, int splits) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || S > 65535 * BQT || H > 65535 ||
      B > 65535 || !head_dim_ok(dh))
    return false;
  return !bf16_in || ((S + BT - 1) / BT <= MAX_TILE_WORDS * 32 &&
                      (T + BT - 1) / BT <= MAX_TILE_WORDS * 32 && splits >= 1 && splits <= H / Hkv);
}

int dispatch(const BwdParams& p, int dh, bool bf16_in, int splits, float* part, cudaStream_t stream) {
  if (bf16_in) {
    switch (dh) {
      case 32: return launch_bf16<32>(p, splits, part, stream);
      case 64: return launch_bf16<64>(p, splits, part, stream);
      case 112: return launch_bf16<112>(p, splits, part, stream);
      case 128: return launch_bf16<128>(p, splits, part, stream);
      case 256: return launch_bf16<256>(p, splits, part, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (dh) {
    case 32: return launch_f32<32>(p, stream);
    case 64: return launch_f32<64>(p, stream);
    case 112: return launch_f32<112>(p, stream);
    case 128: return launch_f32<128>(p, stream);
    case 256: return launch_f32<256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Device pointers of contiguous
// tensors: q, o, dout [B, S, H, dh], k, v [B, T, Hkv, dh] in one type (bf16:
// is_bf16 = 1, else f32), qpos [B, S] and kpos [B, T] int32, lse [B, H, S]
// f32 in; delta [B, H, S] f32 scratch, dq, dk, dv (shapes of q, k, v) out,
// and, for bf16 with splits > 1 (the G heads of a kv-head split across
// that many dK / dV blocks), part: [2, splits, B, T, Hkv, dh] f32 scratch;
// all allocated by the caller.  stream is a cudaStream_t.  Returns
// cudaGetLastError() after the launches (0 = success), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v, const void* o,
                                        const void* dout, const void* qpos, const void* kpos,
                                        const void* lse, void* delta, void* dq, void* dk, void* dv,
                                        void* part, int B, int S, int T, int H, int Hkv, int dh,
                                        int is_bf16, int splits, float scale, int causal,
                                        int window, float softcap, void* stream) {
  if (!shapes_ok(B, S, T, H, Hkv, dh, is_bf16 != 0, splits) ||
      (is_bf16 && splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, o, dout, static_cast<const int*>(qpos), static_cast<const int*>(kpos),
              static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
              B, S, T, H, Hkv, H / Hkv, paged::Mask{scale, softcap, causal, window}};
  return dispatch(p, dh, is_bf16 != 0, splits, static_cast<float*>(part),
                  static_cast<cudaStream_t>(stream));
}

// The blocks each pass of a flash_attention_backward call with these
// arguments launches, from the grids the launches take: out[0 .. 3] = the D
// pass, dK / dV, the sum of the head splits' partials (0 where it is not
// launched), dQ.  Returns 0, or cudaErrorInvalidValue for a shape the
// kernels do not take.  Host only: launches nothing.
extern "C" int flash_attention_backward_blocks(int B, int S, int T, int H, int Hkv, int dh,
                                               int is_bf16, int splits, long long* out) {
  if (!shapes_ok(B, S, T, H, Hkv, dh, is_bf16 != 0, is_bf16 ? splits : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  p.B = B, p.S = S, p.T = T, p.H = H, p.Hkv = Hkv, p.G = H / Hkv;
  const Grids g = grids(p, dh, is_bf16 != 0, is_bf16 ? splits : 1);
  const dim3 d[4] = {g.delta, g.dkv, g.sum, g.dq};
  for (int i = 0; i < 4; ++i) out[i] = (long long)d[i].x * d[i].y * d[i].z;
  return 0;
}
