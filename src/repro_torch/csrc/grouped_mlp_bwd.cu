// The backward of the expert SwiGLU MLP for Hopper, sm_90a: kernels 2b
// (over the capacity buffer [E, C, D]) and 4b (over the grouped, expert-
// sorted buffer [Ct, D]).
//
// The TPU kernels repro/kernels/expert_mlp.py::expert_mlp_kernel (2) and
// repro/kernels/expert_mlp_grouped.py::grouped_mlp_kernel (4) have no
// backward: JAX trains its experts through XLA einsums
// (repro/core/moe.py::experts_ffn) and grouped_mlp_ref.  The port runs its
// hand-written forward kernels on the training path, and autograd cannot
// pass through a ctypes launch, so this file computes the gradient of the
// function kernels 2 and 4 compute (grouped_mlp.cu, grouped_mlp_mma.cu):
// for each live row x of expert e with output gradient dy,
//
//   u  = x Wi, g = x Wg                (f32 sums)
//   a  = silu(g) u, rounded to T       (the forward's down-projection operand)
//   da = dy Wo^T
//   du = da silu(g),  dg = da u s (1 + g (1 - s)),  s = sigmoid(g)
//   dx = du Wi^T + dg Wg^T
//   dWi = sum x^T du,  dWg = sum x^T dg,  dWo = sum a^T dy
//
// with du and dg rounded to T (they are the operands of the next products,
// as flash_attention_bwd.cu rounds dS), every sum in f32 and the outputs
// cast to T.  The weight sums run over expert e's live rows only.
//
// Layouts.  Both buffers are 8-row tiles, each of one expert.  Capacity:
// tile t of [E*C, D] belongs to expert t / (C/8), and its rows past
// min(fill[e], C) are dead (fill is the gating kernel's uncapped count).
// Grouped: te[t] names tile t's expert, and tiles at or past rows_used are
// dead (the dispatch clamps them to expert E-1; they add nothing to it).  A
// dead row gets dx = 0 and adds nothing to any weight gradient; every load
// of one is zero-filled, so its contents do not matter.  An expert no live
// row reaches gets exactly zero weight gradients.
//
// Passes, all on the stream, none synchronising the host:
//   0. prep_kernel (one block): each tile's expert and live rows, the live
//      tiles listed by expert in tile order (a stable compaction by warp
//      ballots), per-expert offsets, and runs of at most RUN_TILES of an
//      expert's listed tiles (64 rows) in expert order; dx zeroed.
//   A. a block per (run, F tile): U, G and dA over D in one k-loop (X and
//      dY share the block's rows), then a, du and dg written to [rows, F]
//      scratch (dead rows: zeros).
//   B. a block per (run, D tile): dX = dU Wi^T + dG Wg^T over F.
//   C. a block per (expert, D tile, F tile): dWi and dWg = X^T [dU dG]
//      over the expert's listed rows in chunks of 32 (4 tiles); and per
//      (expert, F tile, D tile): dWo = A^T dY.
// Deterministic: no atomics in any sum; every output element is summed by
// one block in a fixed order, so two launches on the same inputs are bit
// for bit equal.
//
// bf16 with D and F multiples of 128: the tensor cores, mma.sync m16n8k16
// (bf16 in, f32 accumulate) from ldmatrix (.trans where an operand's
// contraction is not its contiguous axis), tiles staged by cp.async in a
// ring of three (mma_sm90.cuh).  Pass A: 64 rows x 128 columns, 8 warps of
// 32 x 32, three accumulators; pass B: 64 x 128, one; pass C: 128 x 64 with
// two accumulators (dWi, dWg) or 128 x 128 with one (dWo).  Other widths
// and f32: the same passes as f32 FMAs on the CUDA cores out of shared
// memory, 64 x 64 tiles, 4 x 4 outputs a thread.
//
// Bound: 16 rows D F operations (a 2-operation multiply-add each: 6 for
// U, G and dA, 4 for dX, 6 for the weight gradients) and the bytes of the
// live experts' weights read once and their gradients written once, plus
// x, dy and dx.  At llama4-maverick's width (D 5120, F 8192) over 16
// experts and 2048 rows the bytes bound (8 GB: about 2.4 ms of the card's
// 3.35 TB/s against 1.4 ms of operations); this design reads the weights
// twice (passes A and B) and makes a round trip of a, du and dg through
// device memory.  wgmma, TMA and fusing B into A are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int TILE = 8;        // rows a tile (== dispatch_grouped.GROUPED_TILE)
constexpr int RUN_TILES = 8;   // tiles a run: passes A and B take 64 rows a block
constexpr int ROWS = TILE * RUN_TILES;
constexpr int MAX_E = 1024;    // experts the prep kernel takes
constexpr int PREP_THREADS = 1024;
constexpr int NT = 256;        // threads of every other block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// The tile tables prep_kernel writes into the caller's int32 scratch.
struct Tab {
  int* tile_rows;  // [nt] live rows of each tile (0 .. 8)
  int* tile_e;     // [nt] each tile's expert
  int* order;      // [nt] the live tiles, by expert, in tile order within one
  int* offs;       // [E + 1] expert e's tiles: order[offs[e] .. offs[e + 1])
  int* roff;       // [E + 1] expert e's runs: runs[roff[e] .. roff[e + 1])
  int* runs;       // [max_runs][3] (first position in order, tiles, expert)
  int* meta;       // [2] live tiles, runs
};

__host__ __device__ __forceinline__ int max_runs_of(int nt, int E) {
  const int r = (nt + RUN_TILES - 1) / RUN_TILES + E;
  return r < nt ? (r > 1 ? r : 1) : (nt > 1 ? nt : 1);
}

__host__ __device__ __forceinline__ Tab tab_of(int* base, int nt, int E) {
  Tab t;
  t.tile_rows = base;
  t.tile_e = base + nt;
  t.order = base + 2 * nt;
  t.offs = base + 3 * nt;
  t.roff = t.offs + E + 1;
  t.runs = t.roff + E + 1;
  t.meta = t.runs + 3 * max_runs_of(nt, E);
  return t;
}

// Where the tiles' experts and live rows come from: the capacity layout
// (fill != nullptr, tpe = C / 8 tiles an expert) or the grouped one (te,
// rows_used).
struct Layout {
  const int* fill;
  const int* te;
  const int* rows_used;
  int nt, E, C, tpe;
};

__global__ void __launch_bounds__(PREP_THREADS) prep_kernel(const Layout L, int* base) {
  __shared__ int cnt[MAX_E], offs[MAX_E + 1], roff[MAX_E + 1];
  const Tab tb = tab_of(base, L.nt, L.E);
  const int nt = L.nt, E = L.E;
  for (int t = threadIdx.x; t < nt; t += blockDim.x) {
    int e, rows;
    if (L.fill != nullptr) {
      e = t / L.tpe;
      const int live = min(max(L.fill[e], 0), L.C);
      rows = min(max(live - (t % L.tpe) * TILE, 0), TILE);
    } else {
      e = min(max(L.te[t], 0), E - 1);
      rows = min(max(*L.rows_used - t * TILE, 0), TILE);
    }
    tb.tile_e[t] = e;
    tb.tile_rows[t] = rows;
  }
  __syncthreads();  // the block's global writes are visible to it past here
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  auto mine = [&](int t, int e) { return t < nt && tb.tile_rows[t] > 0 && tb.tile_e[t] == e; };
  for (int e = warp; e < E; e += nw) {
    int c = 0;
    for (int b = 0; b < nt; b += 32) c += __popc(__ballot_sync(0xffffffffu, mine(b + lane, e)));
    if (lane == 0) cnt[e] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int o = 0, r = 0;
    for (int e = 0; e < E; ++e) {
      offs[e] = o;
      roff[e] = r;
      o += cnt[e];
      r += (cnt[e] + RUN_TILES - 1) / RUN_TILES;
    }
    offs[E] = o;
    roff[E] = r;
    tb.meta[0] = o;
    tb.meta[1] = r;
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= E; i += blockDim.x) {
    tb.offs[i] = offs[i];
    tb.roff[i] = roff[i];
  }
  for (int e = warp; e < E; e += nw) {
    int pos = offs[e];
    for (int b = 0; b < nt; b += 32) {
      const bool f = mine(b + lane, e);
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) tb.order[pos + __popc(m & ((1u << lane) - 1u))] = b + lane;
      pos += __popc(m);
    }
    const int n = cnt[e];
    for (int i = lane; i * RUN_TILES < n; i += 32) {
      const int r = roff[e] + i;
      tb.runs[3 * r] = offs[e] + i * RUN_TILES;
      tb.runs[3 * r + 1] = min(RUN_TILES, n - i * RUN_TILES);
      tb.runs[3 * r + 2] = e;
    }
  }
}

template <typename T>
struct Bwd {
  const T* x;   // [nt * 8, D]
  const T* wi;  // [E, D, F]
  const T* wg;  // [E, D, F]
  const T* wo;  // [E, F, D]
  const T* dy;  // [nt * 8, D]
  T* dx;        // [nt * 8, D]
  T* dwi;
  T* dwg;
  T* dwo;
  T* act;       // [nt * 8, F] scratch: a, du, dg
  T* du;
  T* dg;
  int* tab;
  int nt, E, D, F;
};

// A run's rows for passes A and B: grow[r] its buffer row (-1 past the
// run), live[r] whether it holds a token.  Returns the run's expert, or -1
// for a block past the runs.  Every thread calls it; it ends on a barrier.
__device__ __forceinline__ int run_setup(const Tab& tb, int run, int* grow, int* live) {
  if (run >= tb.meta[1]) return -1;  // the same for the whole block
  const int pos0 = tb.runs[3 * run], n = tb.runs[3 * run + 1], e = tb.runs[3 * run + 2];
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    const int tp = r / TILE;
    if (tp < n) {
      const int t = tb.order[pos0 + tp];
      grow[r] = t * TILE + r % TILE;
      live[r] = (r % TILE) < tb.tile_rows[t];
    } else {
      grow[r] = -1;
      live[r] = 0;
    }
  }
  __syncthreads();
  return e;
}

// Row k (0 .. 31 or 0 .. 15) of the chunk of an expert's listed rows that
// starts at position pos of order (positions up to end): its buffer row, or
// -1 for a row past the expert's tiles or dead.
__device__ __forceinline__ int chunk_row(const Tab& tb, int pos, int end, int k) {
  const int tp = pos + k / TILE;
  if (tp >= end) return -1;
  const int t = tb.order[tp];
  return (k % TILE) < tb.tile_rows[t] ? t * TILE + k % TILE : -1;
}

__device__ __forceinline__ void silu_backward(float u, float g, float da, float& a, float& du,
                                              float& dg) {
  const float s = 1.f / (1.f + expf(-g));
  const float silu = g * s;
  a = silu * u;
  du = da * silu;
  dg = da * u * s * (1.f + g * (1.f - s));
}

// ---------------------------------------------------------------------------
// f32 FMAs on the CUDA cores (f32, and bf16 at widths the tensor-core path
// does not take): 64 x 64 output tiles, K in steps of 16 staged as f32
// [k][64 + 4], thread (ty, tx) = (tid / 16, tid % 16) owning rows ty*4 ..
// and columns tx*4 .. of the tile.
// ---------------------------------------------------------------------------

constexpr int FB = 64, FK = 16, FLD = FB + 4;

// s[k][i] = get(i, k) for i < 64, k < 16, walking k fastest (a source
// contiguous in k) or i fastest.
template <bool KFAST, class Get>
__device__ __forceinline__ void stage_f32(float (*s)[FLD], Get get) {
  for (int idx = threadIdx.x; idx < FB * FK; idx += NT) {
    const int i = KFAST ? idx / FK : idx % FB;
    const int k = KFAST ? idx % FK : idx / FB;
    s[k][i] = get(i, k);
  }
}

__device__ __forceinline__ void row4(const float (*s)[FLD], int k, int i0, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(&s[k][i0]);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void fma44(float acc[4][4], const float a[4], const float b[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(NT) pass_a_fma(const Bwd<T> p) {
  __shared__ int grow[ROWS], live[ROWS];
  __shared__ __align__(16) float xs[FK][FLD], ys[FK][FLD], is[FK][FLD], gs[FK][FLD], os[FK][FLD];
  const Tab tb = tab_of(p.tab, p.nt, p.E);
  const int e = run_setup(tb, blockIdx.x, grow, live);
  if (e < 0) return;
  const int D = p.D, F = p.F, f0 = blockIdx.y * FB;
  const T* wi = p.wi + (size_t)e * D * F;
  const T* wg = p.wg + (size_t)e * D * F;
  const T* wo = p.wo + (size_t)e * F * D;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float u[4][4] = {}, g[4][4] = {}, da[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += FK) {
    stage_f32<true>(xs, [&](int i, int k) {
      return live[i] && k0 + k < D ? to_f32(p.x[(size_t)grow[i] * D + k0 + k]) : 0.f;
    });
    stage_f32<true>(ys, [&](int i, int k) {
      return live[i] && k0 + k < D ? to_f32(p.dy[(size_t)grow[i] * D + k0 + k]) : 0.f;
    });
    stage_f32<false>(is, [&](int n, int k) {
      return k0 + k < D && f0 + n < F ? to_f32(wi[(size_t)(k0 + k) * F + f0 + n]) : 0.f;
    });
    stage_f32<false>(gs, [&](int n, int k) {
      return k0 + k < D && f0 + n < F ? to_f32(wg[(size_t)(k0 + k) * F + f0 + n]) : 0.f;
    });
    stage_f32<true>(os, [&](int n, int k) {
      return k0 + k < D && f0 + n < F ? to_f32(wo[(size_t)(f0 + n) * D + k0 + k]) : 0.f;
    });
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < FK; ++k) {
      float xa[4], ya[4], bi[4], bg[4], bo[4];
      row4(xs, k, ty * 4, xa);
      row4(ys, k, ty * 4, ya);
      row4(is, k, tx * 4, bi);
      row4(gs, k, tx * 4, bg);
      row4(os, k, tx * 4, bo);
      fma44(u, xa, bi);
      fma44(g, xa, bg);
      fma44(da, ya, bo);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = grow[ty * 4 + i];
    if (r < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f0 + tx * 4 + j;
      if (c >= F) continue;
      float a, du, dg;
      silu_backward(u[i][j], g[i][j], da[i][j], a, du, dg);
      const size_t o = (size_t)r * F + c;
      p.act[o] = from_f32<T>(a);
      p.du[o] = from_f32<T>(du);
      p.dg[o] = from_f32<T>(dg);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) pass_b_fma(const Bwd<T> p) {
  __shared__ int grow[ROWS], live[ROWS];
  __shared__ __align__(16) float us[FK][FLD], gs[FK][FLD], is[FK][FLD], js[FK][FLD];
  const Tab tb = tab_of(p.tab, p.nt, p.E);
  const int e = run_setup(tb, blockIdx.x, grow, live);
  if (e < 0) return;
  const int D = p.D, F = p.F, d0 = blockIdx.y * FB;
  const T* wi = p.wi + (size_t)e * D * F;
  const T* wg = p.wg + (size_t)e * D * F;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < F; k0 += FK) {
    stage_f32<true>(us, [&](int i, int k) {
      return grow[i] >= 0 && k0 + k < F ? to_f32(p.du[(size_t)grow[i] * F + k0 + k]) : 0.f;
    });
    stage_f32<true>(gs, [&](int i, int k) {
      return grow[i] >= 0 && k0 + k < F ? to_f32(p.dg[(size_t)grow[i] * F + k0 + k]) : 0.f;
    });
    stage_f32<true>(is, [&](int n, int k) {
      return d0 + n < D && k0 + k < F ? to_f32(wi[(size_t)(d0 + n) * F + k0 + k]) : 0.f;
    });
    stage_f32<true>(js, [&](int n, int k) {
      return d0 + n < D && k0 + k < F ? to_f32(wg[(size_t)(d0 + n) * F + k0 + k]) : 0.f;
    });
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < FK; ++k) {
      float ua[4], ga[4], bi[4], bg[4];
      row4(us, k, ty * 4, ua);
      row4(gs, k, ty * 4, ga);
      row4(is, k, tx * 4, bi);
      row4(js, k, tx * 4, bg);
      fma44(acc, ua, bi);
      fma44(acc, ga, bg);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = grow[ty * 4 + i];
    if (r < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = d0 + tx * 4 + j;
      if (c < D) p.dx[(size_t)r * D + c] = from_f32<T>(acc[i][j]);
    }
  }
}

// Weight gradients of expert blockIdx.z: out_b[e][m][n] = sum over its
// listed rows k of A[k][m] B_b[k][n], for NB right-hand operands (dWi and
// dWg: A = x, B = du, dg; dWo: A = act, B = dy).  An expert with no rows
// gets zeros.
template <typename T, int NB>
struct WGrad {
  const T* a;
  const T* b[NB];
  T* out[NB];
  int lda, ldb, M, N;
};

template <typename T, int NB>
__global__ void __launch_bounds__(NT) pass_c_fma(const Bwd<T> p, const WGrad<T, NB> w) {
  __shared__ int crow[FK];
  __shared__ __align__(16) float as[FK][FLD], bs[NB][FK][FLD];
  const Tab tb = tab_of(p.tab, p.nt, p.E);
  const int e = blockIdx.z, n0 = blockIdx.x * FB, m0 = blockIdx.y * FB;
  const int pos = tb.offs[e], end = tb.offs[e + 1];
  const int chunks = (end - pos + FK / TILE - 1) / (FK / TILE);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[NB][4][4] = {};
  for (int c = 0; c < chunks; ++c) {
    if (threadIdx.x < FK) crow[threadIdx.x] = chunk_row(tb, pos + c * (FK / TILE), end, threadIdx.x);
    __syncthreads();
    stage_f32<false>(as, [&](int i, int k) {
      return crow[k] >= 0 && m0 + i < w.M ? to_f32(w.a[(size_t)crow[k] * w.lda + m0 + i]) : 0.f;
    });
#pragma unroll
    for (int b = 0; b < NB; ++b)
      stage_f32<false>(bs[b], [&](int i, int k) {
        return crow[k] >= 0 && n0 + i < w.N ? to_f32(w.b[b][(size_t)crow[k] * w.ldb + n0 + i])
                                             : 0.f;
      });
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < FK; ++k) {
      float av[4];
      row4(as, k, ty * 4, av);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        float bv[4];
        row4(bs[b], k, tx * 4, bv);
        fma44(acc[b], av, bv);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= w.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < w.N) w.out[b][((size_t)e * w.M + m) * w.N + n] = from_f32<T>(acc[b][i][j]);
      }
    }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16 over tiles staged by
// cp.async in a ring of STAGES.  A tile is held either K-contiguous
// ([mn][BK + 8], fragments by ldmatrix) or MN-contiguous ([BK][mn + 8],
// fragments by ldmatrix .trans); rows are padded by 16 bytes so the 8 row
// addresses of each 8 x 8 matrix fall on distinct banks.
// ---------------------------------------------------------------------------

constexpr int STAGES = 3, BK = 32, LDK = BK + 8;
constexpr int BNA = 128;  // pass A: F columns a block
constexpr int BNB = 128;  // pass B: D columns a block
constexpr int BMC = 128;  // pass C: rows of the gradient a block

// s[r][c8 * 8 ..] <- src(r) + c8 * 8 for r < R, c8 < C8 (16 bytes each);
// src(r) == nullptr zero-fills row r (dummy: any valid address).
template <int R, int C8, int LD, class Src>
__device__ __forceinline__ void stage(bf16 (*s)[LD], const bf16* dummy, Src src) {
  for (int i = threadIdx.x; i < R * C8; i += NT) {
    const int r = i / C8, c = (i % C8) * 8;
    const bf16* q = src(r);
    cp_async16(&s[r][c], q != nullptr ? q + c : dummy, q != nullptr);
  }
}

// The cp.async ring: load(buf, kt) stages step kt into buffer buf;
// compute(buf) consumes one.  A buffer is refilled only after the barrier
// that follows every thread's compute on it.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int KT, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait_group<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();
    compute(kt % STAGES);
  }
  cp_async_wait_all();
}

// A fragments (16 rows x 16 k) of a K-contiguous tile, rows m0 ..
__device__ __forceinline__ void frag_a_k(uint32_t a[4], const bf16 (*s)[LDK], int m0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, &s[m0 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
}

// A fragments (16 rows x 16 k) of an MN-contiguous tile [k][m], rows m0 ..
template <int LD>
__device__ __forceinline__ void frag_a_mn(uint32_t a[4], const bf16 (*s)[LD], int m0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(a, &s[kk * 16 + (lane & 7) + ((lane >> 4) & 1) * 8][m0 + ((lane >> 3) & 1) * 8]);
}

// B fragments of two 8-column blocks (n0 .., n0 + 8 ..) x 16 k: b[0], b[1]
// the first block's, b[2], b[3] the second's; from a K-contiguous tile
// [n][k] ...
__device__ __forceinline__ void frag_b_k(uint32_t b[4], const bf16 (*s)[LDK], int n0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, &s[n0 + (lane >> 4) * 8 + (lane & 7)][kk * 16 + ((lane >> 3) & 1) * 8]);
}

// ... or an MN-contiguous tile [k][n]
template <int LD>
__device__ __forceinline__ void frag_b_mn(uint32_t b[4], const bf16 (*s)[LD], int n0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, &s[kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][n0 + (lane >> 4) * 8]);
}

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

struct PassASmem {
  bf16 x[STAGES][ROWS][LDK];
  bf16 dy[STAGES][ROWS][LDK];
  bf16 wi[STAGES][BK][BNA + 8];
  bf16 wg[STAGES][BK][BNA + 8];
  bf16 wo[STAGES][BNA][LDK];
  int grow[ROWS];
  int live[ROWS];
};

__global__ void __launch_bounds__(NT) pass_a_mma(const Bwd<bf16> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassASmem& s = *reinterpret_cast<PassASmem*>(smem_raw);
  const Tab tb = tab_of(p.tab, p.nt, p.E);
  const int e = run_setup(tb, blockIdx.x, s.grow, s.live);
  if (e < 0) return;
  const int D = p.D, F = p.F, f0 = blockIdx.y * BNA;
  const bf16* wi = p.wi + (size_t)e * D * F;
  const bf16* wg = p.wg + (size_t)e * D * F;
  const bf16* wo = p.wo + (size_t)e * F * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 rows x 32 columns
  float u[2][4][4] = {}, g[2][4][4] = {}, da[2][4][4] = {};
  auto load = [&](int buf, int kt) {
    const int k0 = kt * BK;
    stage<ROWS, BK / 8, LDK>(s.x[buf], p.x, [&](int r) {
      return s.live[r] ? p.x + (size_t)s.grow[r] * D + k0 : nullptr;
    });
    stage<ROWS, BK / 8, LDK>(s.dy[buf], p.x, [&](int r) {
      return s.live[r] ? p.dy + (size_t)s.grow[r] * D + k0 : nullptr;
    });
    stage<BK, BNA / 8, BNA + 8>(s.wi[buf], p.x, [&](int r) { return wi + (size_t)(k0 + r) * F + f0; });
    stage<BK, BNA / 8, BNA + 8>(s.wg[buf], p.x, [&](int r) { return wg + (size_t)(k0 + r) * F + f0; });
    stage<BNA, BK / 8, LDK>(s.wo[buf], p.x, [&](int r) { return wo + (size_t)(f0 + r) * D + k0; });
  };
  auto compute = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ax[2][4], ay[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        frag_a_k(ax[mi], s.x[buf], wm * 32 + mi * 16, kk);
        frag_a_k(ay[mi], s.dy[buf], wm * 32 + mi * 16, kk);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bi[4], bg[4], bo[4];
        frag_b_mn<BNA + 8>(bi, s.wi[buf], wn * 32 + np * 16, kk);
        frag_b_mn<BNA + 8>(bg, s.wg[buf], wn * 32 + np * 16, kk);
        frag_b_k(bo, s.wo[buf], wn * 32 + np * 16, kk);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_bf16(u[mi][2 * np + h], ax[mi], bi[2 * h], bi[2 * h + 1]);
            mma_bf16(g[mi][2 * np + h], ax[mi], bg[2 * h], bg[2 * h + 1]);
            mma_bf16(da[mi][2 * np + h], ay[mi], bo[2 * h], bo[2 * h + 1]);
          }
      }
    }
  };
  pipeline(D / BK, load, compute);
  const int gid = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = s.grow[wm * 32 + mi * 16 + gid + 8 * h];
      if (r < 0) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float a[2], du[2], dg[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          silu_backward(u[mi][ni][2 * h + j], g[mi][ni][2 * h + j], da[mi][ni][2 * h + j], a[j],
                        du[j], dg[j]);
        const size_t o = (size_t)r * F + f0 + wn * 32 + ni * 8 + c2;
        store_pair(p.act + o, a[0], a[1]);
        store_pair(p.du + o, du[0], du[1]);
        store_pair(p.dg + o, dg[0], dg[1]);
      }
    }
}

struct PassBSmem {
  bf16 du[STAGES][ROWS][LDK];
  bf16 dg[STAGES][ROWS][LDK];
  bf16 wi[STAGES][BNB][LDK];
  bf16 wg[STAGES][BNB][LDK];
  int grow[ROWS];
  int live[ROWS];
};

__global__ void __launch_bounds__(NT) pass_b_mma(const Bwd<bf16> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassBSmem& s = *reinterpret_cast<PassBSmem*>(smem_raw);
  const Tab tb = tab_of(p.tab, p.nt, p.E);
  const int e = run_setup(tb, blockIdx.x, s.grow, s.live);
  if (e < 0) return;
  const int D = p.D, F = p.F, d0 = blockIdx.y * BNB;
  const bf16* wi = p.wi + (size_t)e * D * F;
  const bf16* wg = p.wg + (size_t)e * D * F;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  float acc[2][4][4] = {};
  auto load = [&](int buf, int kt) {
    const int k0 = kt * BK;
    stage<ROWS, BK / 8, LDK>(s.du[buf], p.x, [&](int r) {
      return s.grow[r] >= 0 ? p.du + (size_t)s.grow[r] * F + k0 : nullptr;
    });
    stage<ROWS, BK / 8, LDK>(s.dg[buf], p.x, [&](int r) {
      return s.grow[r] >= 0 ? p.dg + (size_t)s.grow[r] * F + k0 : nullptr;
    });
    stage<BNB, BK / 8, LDK>(s.wi[buf], p.x, [&](int r) { return wi + (size_t)(d0 + r) * F + k0; });
    stage<BNB, BK / 8, LDK>(s.wg[buf], p.x, [&](int r) { return wg + (size_t)(d0 + r) * F + k0; });
  };
  auto compute = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t au[2][4], ag[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        frag_a_k(au[mi], s.du[buf], wm * 32 + mi * 16, kk);
        frag_a_k(ag[mi], s.dg[buf], wm * 32 + mi * 16, kk);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bi[4], bg[4];
        frag_b_k(bi, s.wi[buf], wn * 32 + np * 16, kk);
        frag_b_k(bg, s.wg[buf], wn * 32 + np * 16, kk);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_bf16(acc[mi][2 * np + h], au[mi], bi[2 * h], bi[2 * h + 1]);
            mma_bf16(acc[mi][2 * np + h], ag[mi], bg[2 * h], bg[2 * h + 1]);
          }
      }
    }
  };
  pipeline(F / BK, load, compute);
  const int gid = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = s.grow[wm * 32 + mi * 16 + gid + 8 * h];
      if (r < 0) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        store_pair(p.dx + (size_t)r * D + d0 + wn * 32 + ni * 8 + c2, acc[mi][ni][2 * h],
                   acc[mi][ni][2 * h + 1]);
    }
}

template <int NB, int BN>
struct PassCSmem {
  bf16 a[STAGES][BK][BMC + 8];
  bf16 b[NB][STAGES][BK][BN + 8];
};

// pass C on the tensor cores: a block's BMC x BN tile of NB gradients, 8
// warps of 32 rows x BN / 2 columns (4 x 2), contraction over the expert's
// listed rows in chunks of BK.
template <int NB, int BN>
__global__ void __launch_bounds__(NT) pass_c_mma(const Bwd<bf16> p, const WGrad<bf16, NB> w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassCSmem<NB, BN>& s = *reinterpret_cast<PassCSmem<NB, BN>*>(smem_raw);
  constexpr int NI = BN / 16;  // 8-column blocks a warp
  const Tab tb = tab_of(p.tab, p.nt, p.E);
  const int e = blockIdx.z, n0 = blockIdx.x * BN, m0 = blockIdx.y * BMC;
  const int pos = tb.offs[e], end = tb.offs[e + 1];
  const int chunks = (end - pos + BK / TILE - 1) / (BK / TILE);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  float acc[NB][2][NI][4] = {};
  auto load = [&](int buf, int kt) {
    const int cp = pos + kt * (BK / TILE);
    stage<BK, BMC / 8, BMC + 8>(s.a[buf], p.x, [&](int r) {
      const int g = chunk_row(tb, cp, end, r);
      return g >= 0 ? w.a + (size_t)g * w.lda + m0 : nullptr;
    });
#pragma unroll
    for (int b = 0; b < NB; ++b)
      stage<BK, BN / 8, BN + 8>(s.b[b][buf], p.x, [&](int r) {
        const int g = chunk_row(tb, cp, end, r);
        return g >= 0 ? w.b[b] + (size_t)g * w.ldb + n0 : nullptr;
      });
  };
  auto compute = [&](int buf) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) frag_a_mn<BMC + 8>(a[mi], s.a[buf], wm * 32 + mi * 16, kk);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int np = 0; np < NI / 2; ++np) {
          uint32_t bb[4];
          frag_b_mn<BN + 8>(bb, s.b[b][buf], wn * (BN / 2) + np * 16, kk);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[b][mi][2 * np], a[mi], bb[0], bb[1]);
            mma_bf16(acc[b][mi][2 * np + 1], a[mi], bb[2], bb[3]);
          }
        }
    }
  };
  pipeline(chunks, load, compute);
  // each sum tile through shared memory (the ring is free once every thread
  // is past its last chunk), so its rows leave in 16-byte stores
  const int gid = lane >> 2, c2 = (lane & 3) * 2;
  bf16 (*o)[BN + 8] = reinterpret_cast<bf16 (*)[BN + 8]>(smem_raw);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          store_pair(&o[wm * 32 + mi * 16 + gid + 8 * h][wn * (BN / 2) + ni * 8 + c2],
                     acc[b][mi][ni][2 * h], acc[b][mi][ni][2 * h + 1]);
    __syncthreads();
    for (int i = threadIdx.x; i < BMC * BN / 8; i += NT) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(w.out[b] + ((size_t)e * w.M + m0 + r) * w.N + n0 + c) =
          *reinterpret_cast<const uint4*>(&o[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch_tail(const Bwd<T>& p, bool mma, cudaStream_t stream) {
  cudaError_t err;
  const int runs = max_runs_of(p.nt, p.E);
  const WGrad<T, 2> c1{p.x, {p.du, p.dg}, {p.dwi, p.dwg}, p.D, p.F, p.D, p.F};
  const WGrad<T, 1> c2{p.act, {p.dy}, {p.dwo}, p.F, p.D, p.F, p.D};
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma) {
      constexpr int C1N = 64, C2N = 128;
      static const cudaError_t a1 = cudaFuncSetAttribute(
          pass_a_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(PassASmem));
      static const cudaError_t a2 = cudaFuncSetAttribute(
          pass_b_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(PassBSmem));
      static const cudaError_t a3 = cudaFuncSetAttribute(
          pass_c_mma<2, C1N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)sizeof(PassCSmem<2, C1N>));
      static const cudaError_t a4 = cudaFuncSetAttribute(
          pass_c_mma<1, C2N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)sizeof(PassCSmem<1, C2N>));
      if (a1 != cudaSuccess) return a1;
      if (a2 != cudaSuccess) return a2;
      if (a3 != cudaSuccess) return a3;
      if (a4 != cudaSuccess) return a4;
      pass_a_mma<<<dim3(runs, p.F / BNA), NT, sizeof(PassASmem), stream>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      pass_b_mma<<<dim3(runs, p.D / BNB), NT, sizeof(PassBSmem), stream>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      pass_c_mma<2, C1N><<<dim3(p.F / C1N, p.D / BMC, p.E), NT, sizeof(PassCSmem<2, C1N>), stream>>>(
          p, c1);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      pass_c_mma<1, C2N><<<dim3(p.D / C2N, p.F / BMC, p.E), NT, sizeof(PassCSmem<1, C2N>), stream>>>(
          p, c2);
      return cudaGetLastError();
    }
  }
  pass_a_fma<T><<<dim3(runs, cdiv(p.F, FB)), NT, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass_b_fma<T><<<dim3(runs, cdiv(p.D, FB)), NT, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass_c_fma<T, 2><<<dim3(cdiv(p.F, FB), cdiv(p.D, FB), p.E), NT, 0, stream>>>(p, c1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass_c_fma<T, 1><<<dim3(cdiv(p.D, FB), cdiv(p.F, FB), p.E), NT, 0, stream>>>(p, c2);
  return cudaGetLastError();
}

// Whether a call on these widths takes the tensor-core passes.
bool takes_mma(int is_bf16, int D, int F) { return is_bf16 && D % 128 == 0 && F % 128 == 0; }

template <typename T>
int launch(const Layout& L, const void* x, const void* wi, const void* wg, const void* wo,
           const void* dy, void* dx, void* dwi, void* dwg, void* dwo, void* scratch, int* tab,
           int D, int F, bool mma, cudaStream_t stream) {
  const size_t rows = (size_t)L.nt * TILE;
  T* act = static_cast<T*>(scratch);
  Bwd<T> p{static_cast<const T*>(x), static_cast<const T*>(wi), static_cast<const T*>(wg),
           static_cast<const T*>(wo), static_cast<const T*>(dy), static_cast<T*>(dx),
           static_cast<T*>(dwi), static_cast<T*>(dwg), static_cast<T*>(dwo), act,
           act + rows * F, act + 2 * rows * F, tab, L.nt, L.E, D, F};
  prep_kernel<<<1, PREP_THREADS, 0, stream>>>(L, tab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(dx, 0, rows * D * sizeof(T), stream)) != cudaSuccess) return err;
  return launch_tail<T>(p, mma, stream);
}

int dispatch(const Layout& L, const void* x, const void* wi, const void* wg, const void* wo,
             const void* dy, void* dx, void* dwi, void* dwg, void* dwo, void* scratch, void* tab,
             int D, int F, int is_bf16, void* stream) {
  if (L.nt < 1 || L.E < 1 || L.E > MAX_E || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool mma = takes_mma(is_bf16, D, F);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* t = static_cast<int*>(tab);
  if (is_bf16)
    return launch<bf16>(L, x, wi, wg, wo, dy, dx, dwi, dwg, dwo, scratch, t, D, F, mma, s);
  return launch<float>(L, x, wi, wg, wo, dy, dx, dwi, dwg, dwo, scratch, t, D, F, false, s);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Device pointers of contiguous
// tensors in one type T (is_bf16 = 1: bf16, else f32): wi, wg [E, D, F] and
// wo [E, F, D] in, their gradients dwi, dwg, dwo out (every element
// written); x, dy in and dx out over the buffer's rows; scratch: 3 * rows *
// F values of T; tab: the int32 tables, expert_mlp_backward_table_size
// values; all allocated by the caller.  stream is a cudaStream_t.  Returns
// cudaGetLastError() after the launches (0 = success), or
// cudaErrorInvalidValue for a shape the kernels do not take.

// Kernel 2b: the capacity buffer xe [E, C, D] (C a multiple of 8), fill [E]
// int32 (rows at or past min(fill[e], C) are dead).
extern "C" int expert_mlp_backward(const void* xe, const void* fill, const void* wi,
                                   const void* wg, const void* wo, const void* dy, void* dx,
                                   void* dwi, void* dwg, void* dwo, void* scratch, void* tab,
                                   int E, int C, int D, int F, int is_bf16, void* stream) {
  if (C < TILE || C % TILE) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L{static_cast<const int*>(fill), nullptr, nullptr, E * C / TILE, E, C, C / TILE};
  return dispatch(L, xe, wi, wg, wo, dy, dx, dwi, dwg, dwo, scratch, tab, D, F, is_bf16, stream);
}

// Kernel 4b: the grouped buffer xg [n_tiles * 8, D], te [n_tiles] int32
// (each tile's expert), rows_used [1] int32 (tiles at or past it are dead).
extern "C" int grouped_mlp_backward(const void* xg, const void* te, const void* rows_used,
                                    const void* wi, const void* wg, const void* wo,
                                    const void* dy, void* dx, void* dwi, void* dwg, void* dwo,
                                    void* scratch, void* tab, int n_tiles, int E, int D, int F,
                                    int is_bf16, void* stream) {
  const Layout L{nullptr, static_cast<const int*>(te), static_cast<const int*>(rows_used), n_tiles,
                 E, 0, 0};
  return dispatch(L, xg, wi, wg, wo, dy, dx, dwi, dwg, dwo, scratch, tab, D, F, is_bf16, stream);
}

// Host only: the int32 values of tab for n_tiles tiles over E experts, and
// whether a call on these widths takes the tensor-core passes.
extern "C" int expert_mlp_backward_table_size(int n_tiles, int E) {
  return 3 * n_tiles + 2 * (E + 1) + 3 * max_runs_of(n_tiles, E) + 2;
}

extern "C" int expert_mlp_backward_takes_mma(int is_bf16, int D, int F) {
  return takes_mma(is_bf16, D, F) ? 1 : 0;
}
