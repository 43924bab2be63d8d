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
// dead row gets dx = 0 and adds nothing to any weight gradient, whatever it
// holds; an expert no live row reaches gets exactly zero weight gradients.
//
// Tables (prep_kernel, one block): each tile's expert and live rows, the
// live tiles listed by expert in tile order (a stable compaction by warp
// ballots) and per-expert offsets; for the CUDA-core passes, runs of at most
// RUN_TILES of an expert's listed tiles (64 rows); for the tensor-core
// passes, the packed rows: expert e's listed tiles laid end to end at
// [poff[e], poff[e + 1]), padded with empty rows to a multiple of CHUNK (64),
// prow[] naming each packed row's buffer row (-1 for a dead or padding
// row), and windows of at most WIN (192) of an expert's packed rows in
// expert order.  dx is zeroed.  Nothing synchronises the host.
//
// bf16 with D and F multiples of 128: Hopper's tensor cores, wgmma fed by
// TMA (wgmma_sm90.cuh), in four launches after a pack:
//   pack. x and dy copied to the packed rows, dead and padding rows 0: every
//      operand below is a contiguous 2-D box of a tensor map, and a dead row
//      is 0 in shared memory before any product reads it.
//   A. a block per (F tile of 64, window): U, G and dA over D in k-steps of
//      64, then a, du and dg written to packed [P, F] scratch (a padding
//      row's are 0: its x and dy are).
//   B. a block per (D tile of 128, window): dX = dU Wi^T + dG Wg^T over F,
//      stored to each live row's buffer row.
//   C. persistent blocks (one an SM) walking output tiles (expert, 128
//      rows, BN columns) in expert order: dWi and dWg = X^T [dU dG] (BN 128)
//      and dWo = A^T dY (BN 256) over the expert's packed rows in k-steps of
//      64; an expert with no row writes zeros.
// Each launch is warp-specialised: one producer thread keeps TMA loads
// (128-byte swizzle) in flight into an mbarrier ring (A: 3 stages of up to
// 72 KB, B: 2 of up to 80 KB, C: 3 of 48 KB); consumer warpgroups issue
// wgmma m64nNk16 from shared memory (A: three of 64 rows, 3 x 32 f32
// accumulators; B: three, 64; C: two, 128), waiting on each stage's
// mbarrier in one block of PTX (mbar_wait_ptx: ptxas's C7518
// serialisation).  Rows come in boxes of 64, one a busy warpgroup: a
// window's warpgroups past its rows neither load nor compute.  Wi and Wg
// in pass A and every operand of pass C are MN-major, taken transposed by
// the descriptor.  Pass C's tiles leave through shared memory (stmatrix,
// swizzled as TMA writes them) by TMA stores with an L2 evict-first hint,
// which run on while the next tile's products do.  ptxas compiles every
// thread to the launch bound's registers (128 at 512 threads), so the row
// passes keep 96 / 64 accumulators and no setmaxnreg; a 256-column pass B
// (128 accumulators) does not compile there.
//
// Weight crossings.  A window holds an expert's rows up to 192, so each
// weight tile crosses from L2 to an SM once per window in passes A and B:
// at llama4-maverick's width (16 experts, top-1 at 2048 tokens, C = 160)
// once per expert, at kimi-k2's (32 experts, top-8 at 1024 tokens, about
// 256 rows an expert, C = 320) twice; the mma.sync passes this replaced
// crossed once per 64 rows (2-3 and 4-5 times).  Pass C reads no weight;
// it reads an expert's x / a strip N / BN times and its du, dg / dy strips
// M / 128 times, all from L2.
//
// Bound: 16 rows D F operations (a 2-operation multiply-add each: 6 for
// U, G and dA, 4 for dX, 6 for the weight gradients) and the bytes of the
// live experts' weights read once and their gradients written once, plus
// x, dy and dx.  At llama4-maverick's width over 16 experts and 2048 rows
// the bytes bound (8 GB: about 2.4 ms of the card's 3.35 TB/s against 1.4
// ms of operations); at kimi-k2's the two meet (about 1.9 ms each).  This
// design reads the weights twice (passes A and B), 1.7 x the bytes bound's
// reads at llama4's width, and makes a round trip of a, du and dg through
// device memory.  On an H100 (launch/training_kernels.py --variants,
// PERF.md) passes A and B are bound by what crosses from L2 to the SMs:
// without their weight tiles they still take about two thirds of their
// time, most of it X / dY (dU / dG) re-read for every F (D) tile; pass C
// by its loads and stores together (either alone leaves 55-70% of it).
// Tried and slower: a two-block cluster multicasting the row tiles to
// neighbouring F (D) tiles (the blocks stall on each other's stages: A
// 1.7 x), and an L2 evict-first hint on the weight loads.  What is left:
// fusing B into A (a deterministic sum of dX across F tiles), and wider
// row-pass tiles once the register bound allows.
//
// Other widths and f32: the same passes as f32 FMAs on the CUDA cores out
// of shared memory, 64 x 64 tiles, 4 x 4 outputs a thread, over the runs.
//
// Deterministic: no atomics in any sum; every output element is summed by
// one block in a fixed order, so two launches on the same inputs are bit
// for bit equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int TILE = 8;        // rows a tile (== dispatch_grouped.GROUPED_TILE)
constexpr int RUN_TILES = 8;   // tiles a run of the CUDA-core row passes: 64 rows a block
constexpr int ROWS = TILE * RUN_TILES;
constexpr int CHUNK = 64;      // an expert's packed rows: a multiple of this (pass C's k-step)
constexpr int WIN = 192;       // packed rows a tensor-core row-pass window (3 x 64)
constexpr int WIN_TILES = WIN / TILE;
constexpr int MAX_E = 1024;    // experts the prep kernel takes
constexpr int PREP_THREADS = 1024;
constexpr int NT = 256;        // threads of every CUDA-core block

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
  int* poff;       // [E + 1] expert e's packed rows: [poff[e], poff[e + 1])
  int* wins;       // [max_wins][3] (first packed row, end, expert)
  int* prow;       // [packed_rows] each packed row's buffer row (-1: dead or padding)
  int* meta;       // [3] live tiles, runs, windows
};

__host__ __device__ __forceinline__ int max_runs_of(int nt, int E) {
  const int r = (nt + RUN_TILES - 1) / RUN_TILES + E;
  return r < nt ? (r > 1 ? r : 1) : (nt > 1 ? nt : 1);
}

// Experts with a live tile: at most min(E, nt).  Expert e's c tiles take
// ceil(c / WIN_TILES) windows and 8 c rows padded to a multiple of CHUNK.
__host__ __device__ __forceinline__ int max_wins_of(int nt, int E) {
  return nt / WIN_TILES + (E < nt ? E : nt);
}

__host__ __device__ __forceinline__ int packed_rows_of(int nt, int E) {
  return TILE * nt + (CHUNK - TILE) * (E < nt ? E : nt);
}

__host__ __device__ __forceinline__ Tab tab_of(int* base, int nt, int E) {
  Tab t;
  t.tile_rows = base;
  t.tile_e = base + nt;
  t.order = base + 2 * nt;
  t.offs = base + 3 * nt;
  t.roff = t.offs + E + 1;
  t.runs = t.roff + E + 1;
  t.poff = t.runs + 3 * max_runs_of(nt, E);
  t.wins = t.poff + E + 1;
  t.prow = t.wins + 3 * max_wins_of(nt, E);
  t.meta = t.prow + packed_rows_of(nt, E);
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
  __shared__ int cnt[MAX_E], offs[MAX_E + 1], roff[MAX_E + 1], poff[MAX_E + 1], woff[MAX_E + 1];
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
    int o = 0, r = 0, q = 0, w = 0;
    for (int e = 0; e < E; ++e) {
      offs[e] = o;
      roff[e] = r;
      poff[e] = q;
      woff[e] = w;
      const int padded = (cnt[e] * TILE + CHUNK - 1) / CHUNK * CHUNK;
      o += cnt[e];
      r += (cnt[e] + RUN_TILES - 1) / RUN_TILES;
      q += padded;
      w += (padded + WIN - 1) / WIN;
    }
    offs[E] = o;
    roff[E] = r;
    poff[E] = q;
    woff[E] = w;
    tb.meta[0] = o;
    tb.meta[1] = r;
    tb.meta[2] = w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= E; i += blockDim.x) {
    tb.offs[i] = offs[i];
    tb.roff[i] = roff[i];
    tb.poff[i] = poff[i];
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
    __syncwarp();  // the warp's order entries are visible to all its lanes
    const int q0 = poff[e], np = poff[e + 1] - q0;
    for (int i = lane; i < np; i += 32) {
      int g = -1;
      if (i < n * TILE) {
        const int t = tb.order[offs[e] + i / TILE];
        if (i % TILE < tb.tile_rows[t]) g = t * TILE + i % TILE;
      }
      tb.prow[q0 + i] = g;
    }
    for (int i = lane; woff[e] + i < woff[e + 1]; i += 32) {
      const int w = woff[e] + i;
      tb.wins[3 * w] = q0 + i * WIN;
      tb.wins[3 * w + 1] = min(q0 + (i + 1) * WIN, q0 + np);
      tb.wins[3 * w + 2] = e;
    }
  }
  for (int i = poff[E] + threadIdx.x; i < packed_rows_of(nt, E); i += blockDim.x) tb.prow[i] = -1;
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
  T* act;       // scratch: a, du, dg ([nt * 8, F] each on the CUDA cores; packed [P, F] on
  T* du;        // the tensor cores)
  T* dg;
  int* tab;
  int nt, E, D, F;
};

// A run's rows for the CUDA-core passes A and B: grow[r] its buffer row
// (-1 past the run), live[r] whether it holds a token.  Returns the run's
// expert, or -1 for a block past the runs.  Every thread calls it; it ends
// on a barrier.
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

// Row k (0 .. 15) of the chunk of an expert's listed rows that starts at
// position pos of order (positions up to end): its buffer row, or -1 for a
// row past the expert's tiles or dead.
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
// bf16 on the tensor cores: wgmma fed by TMA, over the packed rows.  Every
// tile is stored as TMA writes it with the 128-byte swizzle: boxes of 64
// columns (128 bytes) by some rows, 1024-byte aligned.
// ---------------------------------------------------------------------------

constexpr int BK = 64;            // contraction step of the row passes (one swizzled row)
constexpr int RWG = WIN / 64;     // consumer warpgroups of the row passes
constexpr int RNT = 128 * (RWG + 1);  // and the producer's
constexpr int BNA = 64;           // pass A: F columns a block
constexpr int BNB = 128;          // pass B: D columns a block
constexpr int BMC = 128;          // pass C: gradient rows a tile (two consumer warpgroups)
constexpr int CNT = 128 * 3;      // pass C: two consumer warpgroups and the producer's
constexpr int AST = 3, BST = 2, CST = 3;  // stages of each ring
constexpr int BOX = 64 * 64 * 2;  // bytes of a 64 x 64 box

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// A ring position: its stage and the parity of the stage's current phase.
struct Ring {
  int st = 0;
  unsigned ph = 0;
  __device__ __forceinline__ void next(int n) {
    if (++st == n) {
      st = 0;
      ph ^= 1u;
    }
  }
};

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// Row p of xp / yp [P, D] is row prow[p] of x / dy, or zeros.
__global__ void __launch_bounds__(256) pack_kernel(const bf16* x, const bf16* dy, bf16* xp, bf16* yp,
                                                   const int* prow, int D) {
  const int p = blockIdx.x, g = prow[p], n = D / 8;
  const uint4* xs = reinterpret_cast<const uint4*>(x) + (size_t)max(g, 0) * n;
  const uint4* ys = reinterpret_cast<const uint4*>(dy) + (size_t)max(g, 0) * n;
  uint4* xd = reinterpret_cast<uint4*>(xp) + (size_t)p * n;
  uint4* yd = reinterpret_cast<uint4*>(yp) + (size_t)p * n;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    xd[c] = g >= 0 ? xs[c] : z;
    yd[c] = g >= 0 ? ys[c] : z;
  }
}

struct PassAArgs {
  CUtensorMap x, dy;   // packed x, dy [P, D]: boxes of 64 x 64
  CUtensorMap wi, wg;  // wi, wg as [E D, F]: 64 x 64
  CUtensorMap wo;      // wo as [E F, D]: 64 x 64
  bf16* act;           // packed a, du, dg [P, F]
  bf16* du;
  bf16* dg;
  const int* tab;
  int nt, E, D, F;
};

struct PassASmem {
  bf16 x[AST][WIN][BK];
  bf16 dy[AST][WIN][BK];
  bf16 wi[AST][BK][BNA];  // [d][f]: B MN-major
  bf16 wg[AST][BK][BNA];
  bf16 wo[AST][BNA][BK];  // [f][d]: B K-major
  uint64_t full[AST], empty[AST];
};

// Pass A: a block per (F tile, window); consumer warpgroup w takes the
// window's rows 64 w .. 64 w + 63, loaded only for a warpgroup with rows (a
// window is a multiple of 64 rows; a warpgroup with none sits out, and the
// stages' empty barriers count only the busy warps).
__global__ void __launch_bounds__(RNT, 1) pass_a_wg(const __grid_constant__ PassAArgs p) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassASmem& s = *reinterpret_cast<PassASmem*>(align1024(smem_raw));
  const Tab tb = tab_of(const_cast<int*>(p.tab), p.nt, p.E);
  const int w = blockIdx.y;
  if (w >= tb.meta[2]) return;  // the same for the whole block
  const int r0 = tb.wins[3 * w], r1 = tb.wins[3 * w + 1], e = tb.wins[3 * w + 2];
  const int f0 = blockIdx.x * BNA, KT = p.D / BK;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int busy = (r1 - r0) / 64;  // consumer warpgroups with rows (1 .. RWG)
  if (tid == 0) {
    for (int i = 0; i < AST; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 4 * busy);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == RWG) {
    if (tid == RWG * 128) {
      Ring r;
      for (int kt = 0; kt < KT; ++kt, r.next(AST)) {
        const int k0 = kt * BK;
        uint64_t* bar = &s.full[r.st];
        mbar_wait_ptx(&s.empty[r.st], r.ph ^ 1u);  // a fresh stage passes at once
        mbar_expect_tx(bar, 2 * busy * BOX + 3 * BK * BNA * 2);
        for (int i = 0; i < busy; ++i) {
          tma_load_2d(&s.x[r.st][64 * i][0], &p.x, bar, k0, r0 + 64 * i);
          tma_load_2d(&s.dy[r.st][64 * i][0], &p.dy, bar, k0, r0 + 64 * i);
        }
        tma_load_2d(&s.wi[r.st][0][0], &p.wi, bar, f0, e * p.D + k0);
        tma_load_2d(&s.wg[r.st][0][0], &p.wg, bar, f0, e * p.D + k0);
        tma_load_2d(&s.wo[r.st][0][0], &p.wo, bar, k0, e * p.F + f0);
      }
    }
  } else if (wg < busy) {
    float u[BNA / 2], g[BNA / 2], da[BNA / 2];
#pragma unroll
    for (int i = 0; i < BNA / 2; ++i) u[i] = g[i] = da[i] = 0.f;
    Ring r;
    for (int kt = 0; kt < KT; ++kt, r.next(AST)) {
      mbar_wait_ptx(&s.full[r.st], r.ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t ax = desc_sw128(&s.x[r.st][64 * wg][16 * kk], 16, 1024);
        const uint64_t ay = desc_sw128(&s.dy[r.st][64 * wg][16 * kk], 16, 1024);
        wgmma_ss_n64_tb(u, ax, desc_sw128(&s.wi[r.st][16 * kk][0], BK * 128, 1024));
        wgmma_ss_n64_tb(g, ax, desc_sw128(&s.wg[r.st][16 * kk][0], BK * 128, 1024));
        wgmma_ss_n64(da, ay, desc_sw128(&s.wo[r.st][0][16 * kk], 16, 1024), 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(u);
      fence_acc(g);
      fence_acc(da);
      if ((tid & 31) == 0) mbar_arrive(&s.empty[r.st]);
    }
    // this thread's rows rl, rl + 8 and columns 8 n + c2, + 1 of each group
    const int lane = tid & 31;
    const int rl = r0 + 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2), c2 = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t o = (size_t)(rl + 8 * h) * p.F + f0 + c2;
#pragma unroll
      for (int n = 0; n < BNA / 8; ++n) {
        const int i = 4 * n + 2 * h;
        float a[2], du[2], dg[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) silu_backward(u[i + j], g[i + j], da[i + j], a[j], du[j], dg[j]);
        store_pair(p.act + o + 8 * n, a[0], a[1]);
        store_pair(p.du + o + 8 * n, du[0], du[1]);
        store_pair(p.dg + o + 8 * n, dg[0], dg[1]);
      }
    }
  }
}

struct PassBArgs {
  CUtensorMap du, dg;  // packed du, dg [P, F]: boxes of 64 x 64
  CUtensorMap wi, wg;  // wi, wg as [E D, F]: 64 x BNB
  bf16* dx;
  const int* tab;
  int nt, E, D, F;
};

struct PassBSmem {
  bf16 du[BST][WIN][BK];
  bf16 dg[BST][WIN][BK];
  bf16 wi[BST][BNB][BK];  // [d][f]: B K-major
  bf16 wg[BST][BNB][BK];
  uint64_t full[BST], empty[BST];
};

// Pass B: a block per (D tile, window), rows as pass A's; each live row's
// dX goes to its buffer row.
__global__ void __launch_bounds__(RNT, 1) pass_b_wg(const __grid_constant__ PassBArgs p) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassBSmem& s = *reinterpret_cast<PassBSmem*>(align1024(smem_raw));
  const Tab tb = tab_of(const_cast<int*>(p.tab), p.nt, p.E);
  const int w = blockIdx.y;
  if (w >= tb.meta[2]) return;
  const int r0 = tb.wins[3 * w], r1 = tb.wins[3 * w + 1], e = tb.wins[3 * w + 2];
  const int d0 = blockIdx.x * BNB, KT = p.F / BK;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int busy = (r1 - r0) / 64;
  if (tid == 0) {
    for (int i = 0; i < BST; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 4 * busy);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == RWG) {
    if (tid == RWG * 128) {
      Ring r;
      for (int kt = 0; kt < KT; ++kt, r.next(BST)) {
        const int k0 = kt * BK;
        uint64_t* bar = &s.full[r.st];
        mbar_wait_ptx(&s.empty[r.st], r.ph ^ 1u);
        mbar_expect_tx(bar, 2 * busy * BOX + 2 * BNB * BK * 2);
        for (int i = 0; i < busy; ++i) {
          tma_load_2d(&s.du[r.st][64 * i][0], &p.du, bar, k0, r0 + 64 * i);
          tma_load_2d(&s.dg[r.st][64 * i][0], &p.dg, bar, k0, r0 + 64 * i);
        }
        tma_load_2d(&s.wi[r.st][0][0], &p.wi, bar, k0, e * p.D + d0);
        tma_load_2d(&s.wg[r.st][0][0], &p.wg, bar, k0, e * p.D + d0);
      }
    }
  } else if (wg < busy) {
    float acc[BNB / 2];
#pragma unroll
    for (int i = 0; i < BNB / 2; ++i) acc[i] = 0.f;
    Ring r;
    for (int kt = 0; kt < KT; ++kt, r.next(BST)) {
      mbar_wait_ptx(&s.full[r.st], r.ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wgmma_ss_n128(acc, desc_sw128(&s.du[r.st][64 * wg][16 * kk], 16, 1024),
                      desc_sw128(&s.wi[r.st][0][16 * kk], 16, 1024), 1);
        wgmma_ss_n128(acc, desc_sw128(&s.dg[r.st][64 * wg][16 * kk], 16, 1024),
                      desc_sw128(&s.wg[r.st][0][16 * kk], 16, 1024), 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(acc);
      if ((tid & 31) == 0) mbar_arrive(&s.empty[r.st]);
    }
    const int lane = tid & 31;
    const int rl = r0 + 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2), c2 = (lane & 3) * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tb.prow[rl + 8 * h];
      if (row < 0) continue;
      bf16* out = p.dx + (size_t)row * p.D + d0 + c2;
#pragma unroll
      for (int n = 0; n < BNB / 8; ++n) store_pair(out + 8 * n, acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    }
  }
}

// Pass C's weight gradients out_b[e][m][n] = sum over expert e's packed
// rows k of A[k][m] B_b[k][n], NB right-hand operands (dWi and dWg: A = x,
// B = du, dg; dWo: A = act, B = dy), each output tile BMC x BN.
template <int NB, int BN>
struct PassCArgs {
  CUtensorMap a;        // [P, M]: boxes of 64 columns x CHUNK rows
  CUtensorMap b[NB];    // [P, N]: the same
  CUtensorMap out[NB];  // [E, M, N] as [E M, N]: boxes of 64 x 64
  const int* tab;
  int nt, E, M, N;
};

template <int NB, int BN>
struct PassCSmem {
  bf16 a[CST][2][CHUNK][64];            // two boxes along M; the rows are the contraction
  bf16 b[CST][NB][BN / 64][CHUNK][64];  // BN / 64 boxes along N
  bf16 out[2][NB][BN / 64][64][64];     // each consumer warpgroup's sum tiles, swizzled
  uint64_t full[CST], empty[CST];
};

template <int BN>
__device__ __forceinline__ void wgmma_tt(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    hopper::wgmma_ss_n256_tt(d, da, db);
  else
    hopper::wgmma_ss_n128_tt(d, da, db);
}

// Pass C: persistent blocks; block b takes tiles b, b + gridDim.x, ... of
// (expert, M tile, N tile), N fastest.  Columns past N (a last N tile of
// 128 when BN = 256) load as zeros and are not stored.
template <int NB, int BN>
__global__ void __launch_bounds__(CNT, 1) pass_c_wg(const __grid_constant__ PassCArgs<NB, BN> p) {
  using namespace hopper;
  using Sm = PassCSmem<NB, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(align1024(smem_raw));
  const Tab tb = tab_of(const_cast<int*>(p.tab), p.nt, p.E);
  const int MT = p.M / BMC, NTL = (p.N + BN - 1) / BN, tiles = p.E * MT * NTL;
  const int tid = threadIdx.x, wg = tid >> 7;
  if (tid == 0) {
    for (int i = 0; i < CST; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (wg == 2) {
    if (tid == 256) {
      Ring r;
      for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
        const int e = u / (MT * NTL), m0 = (u / NTL) % MT * BMC, n0 = u % NTL * BN;
        for (int q = tb.poff[e]; q < tb.poff[e + 1]; q += CHUNK, r.next(CST)) {
          uint64_t* bar = &s.full[r.st];
          mbar_wait_ptx(&s.empty[r.st], r.ph ^ 1u);
          mbar_expect_tx(bar, (2 + NB * BN / 64) * BOX);
#pragma unroll
          for (int j = 0; j < 2; ++j) tma_load_2d(&s.a[r.st][j][0][0], &p.a, bar, m0 + 64 * j, q);
#pragma unroll
          for (int b = 0; b < NB; ++b)
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_2d(&s.b[r.st][b][j][0][0], &p.b[b], bar, n0 + 64 * j, q);
        }
      }
    }
  } else {
    const int lane = tid & 31, warp = (tid >> 5) & 3, lead = (tid & 127) == 0;
    float acc[NB][BN / 2];
    Ring r;
    for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
      const int e = u / (MT * NTL), m0 = (u / NTL) % MT * BMC, n0 = u % NTL * BN;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[b][i] = 0.f;
      for (int q = tb.poff[e]; q < tb.poff[e + 1]; q += CHUNK, r.next(CST)) {
        mbar_wait_ptx(&s.full[r.st], r.ph);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk) {
          const uint64_t da = desc_sw128(&s.a[r.st][wg][16 * kk][0], BOX, 1024);
#pragma unroll
          for (int b = 0; b < NB; ++b)
            wgmma_tt<BN>(acc[b], da, desc_sw128(&s.b[r.st][b][0][16 * kk][0], BOX, 1024));
        }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int b = 0; b < NB; ++b) fence_acc(acc[b]);
        if (lane == 0) mbar_arrive(&s.empty[r.st]);
      }
      // the sum tiles through shared memory, in the layout a TMA load of the
      // output's map writes (element (row, col) of a box at byte row * 128 +
      // ((col / 8) ^ (row % 8)) * 16 + (col % 8) * 2), then out by TMA stores
      // that run on while the next tile's products do; a tile is rewritten
      // only once the stores of the last one have read it
      if (lead) bulk_wait<0, true>();
      bar_sync(1 + wg, 128);
      const int mat = lane >> 3, row = 16 * warp + 8 * (mat & 1) + (lane & 7);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        unsigned char* tile = reinterpret_cast<unsigned char*>(&s.out[wg][b][0][0][0]);
#pragma unroll
        for (int n = 0; n < BN / 8; n += 2) {
          const int c = n + (mat >> 1);  // this lane's 8-column group
          stmatrix_x4(tile + (c >> 3) * BOX + row * 128 + (((c & 7) ^ (row & 7)) << 4),
                      pack_bf16(acc[b][4 * n], acc[b][4 * n + 1]),
                      pack_bf16(acc[b][4 * n + 2], acc[b][4 * n + 3]),
                      pack_bf16(acc[b][4 * n + 4], acc[b][4 * n + 5]),
                      pack_bf16(acc[b][4 * n + 6], acc[b][4 * n + 7]));
        }
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      if (lead) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            if (n0 + 64 * j < p.N)
              tma_store_2d(&p.out[b], &s.out[wg][b][j][0][0], n0 + 64 * j, e * p.M + m0 + 64 * wg);
        bulk_commit();
      }
    }
    if (lead) bulk_wait<0, false>();  // the block's shared memory outlives its stores
  }
}

// A bf16 matrix [rows, cols] (cols innermost) as a 2-D tensor map with boxes
// of 64 columns x box_rows and the 128-byte swizzle; reads past its edge give
// 0 (swizzle, L2 promotion and fill as flash_attention.cu's maps).
bool encode_2d(CUtensorMap* map, const void* base, int cols, long long rows, int box_rows) {
  const hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB, int BN>
int launch_pass_c(PassCArgs<NB, BN>& c, const bf16* a, const bf16* const* b, bf16* const* out,
                  int P, int sms, cudaStream_t stream) {
  const int smem = (int)sizeof(PassCSmem<NB, BN>) + 1024;  // + the 1024-byte alignment
  static const cudaError_t attr =
      cudaFuncSetAttribute(pass_c_wg<NB, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (!encode_2d(&c.a, a, c.M, P, CHUNK)) return cudaErrorInvalidValue;
  for (int i = 0; i < NB; ++i)
    if (!encode_2d(&c.b[i], b[i], c.N, P, CHUNK) ||
        !encode_2d(&c.out[i], out[i], c.N, (long long)c.E * c.M, 64))
      return cudaErrorInvalidValue;
  const long long tiles = (long long)c.E * (c.M / BMC) * ((c.N + BN - 1) / BN);
  pass_c_wg<NB, BN><<<(int)(tiles < sms ? tiles : sms), CNT, smem, stream>>>(c);
  return cudaGetLastError();
}

// The tensor-core passes after prep_kernel: xp, yp the packed x and dy.
int launch_wgmma(const Bwd<bf16>& p, bf16* xp, bf16* yp, cudaStream_t stream) {
  const int P = packed_rows_of(p.nt, p.E), wins = max_wins_of(p.nt, p.E);
  if (wins > 65535) return cudaErrorInvalidValue;
  const int smem_a = (int)sizeof(PassASmem) + 1024, smem_b = (int)sizeof(PassBSmem) + 1024;
  static const cudaError_t a1 =
      cudaFuncSetAttribute(pass_a_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  static const cudaError_t a2 =
      cudaFuncSetAttribute(pass_b_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (a1 != cudaSuccess) return a1;
  if (a2 != cudaSuccess) return a2;
  const int D = p.D, F = p.F;
  const long long ED = (long long)p.E * D, EF = (long long)p.E * F;
  PassAArgs a{};
  PassBArgs b{};
  if (!encode_2d(&a.x, xp, D, P, 64) || !encode_2d(&a.dy, yp, D, P, 64) ||
      !encode_2d(&a.wi, p.wi, F, ED, BK) || !encode_2d(&a.wg, p.wg, F, ED, BK) ||
      !encode_2d(&a.wo, p.wo, D, EF, BNA) || !encode_2d(&b.du, p.du, F, P, 64) ||
      !encode_2d(&b.dg, p.dg, F, P, 64) || !encode_2d(&b.wi, p.wi, F, ED, BNB) ||
      !encode_2d(&b.wg, p.wg, F, ED, BNB))
    return cudaErrorInvalidValue;
  a.act = p.act, a.du = p.du, a.dg = p.dg, a.tab = p.tab, a.nt = p.nt, a.E = p.E, a.D = D, a.F = F;
  b.dx = p.dx, b.tab = p.tab, b.nt = p.nt, b.E = p.E, b.D = D, b.F = F;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    return cudaErrorInvalidValue;
  const Tab tb = tab_of(p.tab, p.nt, p.E);
  cudaError_t err;
  pack_kernel<<<P, 256, 0, stream>>>(p.x, p.dy, xp, yp, tb.prow, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass_a_wg<<<dim3(F / BNA, wins), RNT, smem_a, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass_b_wg<<<dim3(D / BNB, wins), RNT, smem_b, stream>>>(b);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bf16* const b1[2] = {p.du, p.dg};
  bf16* const o1[2] = {p.dwi, p.dwg};
  PassCArgs<2, 128> c1{};
  c1.tab = p.tab, c1.nt = p.nt, c1.E = p.E, c1.M = D, c1.N = F;
  const int rc = launch_pass_c<2, 128>(c1, xp, b1, o1, P, sms, stream);
  if (rc != cudaSuccess) return rc;
  PassCArgs<1, 256> c2{};
  c2.tab = p.tab, c2.nt = p.nt, c2.E = p.E, c2.M = F, c2.N = D;
  return launch_pass_c<1, 256>(c2, p.act, &yp, &p.dwo, P, sms, stream);
}

// ---------------------------------------------------------------------------

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch_fma(const Bwd<T>& p, cudaStream_t stream) {
  cudaError_t err;
  const int runs = max_runs_of(p.nt, p.E);
  const WGrad<T, 2> c1{p.x, {p.du, p.dg}, {p.dwi, p.dwg}, p.D, p.F, p.D, p.F};
  const WGrad<T, 1> c2{p.act, {p.dy}, {p.dwo}, p.F, p.D, p.F, p.D};
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

// Values of T in the caller's scratch: the tensor-core passes' packed a, du,
// dg [P, F] and x, dy [P, D] (the CUDA-core passes use the first 3 rows F).
long long scratch_size_of(int nt, int E, int D, int F) {
  return (long long)packed_rows_of(nt, E) * (3LL * F + 2LL * D);
}

template <typename T>
int launch(const Layout& L, const void* x, const void* wi, const void* wg, const void* wo,
           const void* dy, void* dx, void* dwi, void* dwg, void* dwo, void* scratch, int* tab,
           int D, int F, bool mma, cudaStream_t stream) {
  const size_t rows = (size_t)L.nt * TILE;
  const size_t P = mma ? (size_t)packed_rows_of(L.nt, L.E) : rows;  // rows of a, du, dg
  T* act = static_cast<T*>(scratch);
  Bwd<T> p{static_cast<const T*>(x), static_cast<const T*>(wi), static_cast<const T*>(wg),
           static_cast<const T*>(wo), static_cast<const T*>(dy), static_cast<T*>(dx),
           static_cast<T*>(dwi), static_cast<T*>(dwg), static_cast<T*>(dwo), act,
           act + P * F, act + 2 * P * F, tab, L.nt, L.E, D, F};
  prep_kernel<<<1, PREP_THREADS, 0, stream>>>(L, tab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(dx, 0, rows * D * sizeof(T), stream)) != cudaSuccess) return err;
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma) return launch_wgmma(p, act + 3 * P * F, act + 3 * P * F + P * D, stream);
  }
  return launch_fma<T>(p, stream);
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
// written); x, dy in and dx out over the buffer's rows; scratch:
// expert_mlp_backward_scratch_size values of T; tab: the int32 tables,
// expert_mlp_backward_table_size values; all allocated by the caller.
// stream is a cudaStream_t.  Returns cudaGetLastError() after the launches
// (0 = success), or cudaErrorInvalidValue for a shape the kernels do not
// take.

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

// Host only: the int32 values of tab and the values of T in scratch for
// n_tiles tiles over E experts at widths D, F, and whether a call on these
// widths takes the tensor-core passes.
extern "C" int expert_mlp_backward_table_size(int n_tiles, int E) {
  return 3 * n_tiles + 3 * (E + 1) + 3 * max_runs_of(n_tiles, E) + 3 * max_wins_of(n_tiles, E) +
         packed_rows_of(n_tiles, E) + 3;
}

extern "C" long long expert_mlp_backward_scratch_size(int n_tiles, int E, int D, int F) {
  return scratch_size_of(n_tiles, E, D, F);
}

extern "C" int expert_mlp_backward_takes_mma(int is_bf16, int D, int F) {
  return takes_mma(is_bf16, D, F) ? 1 : 0;
}
