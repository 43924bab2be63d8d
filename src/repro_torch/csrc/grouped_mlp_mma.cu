// Grouped (dropless) and capacity expert SwiGLU MLP on the tensor cores,
// for Hopper (sm_90a), bf16 activations.
//
// Replaces, for bf16 activations, the TPU kernels
// repro/kernels/expert_mlp_grouped.py::grouped_mlp_kernel (kernel 4, bf16
// weights), ::grouped_mlp_quant_kernel (kernel 5, MoQ weights: int8
// [E, D, F] / [E, F, D], or int4 packed two per byte along the contraction
// axis, [E, D/2, F] / [E, F/2, D], byte (r, n) holding rows 2r and 2r+1 of
// column n in its low and high nibble; f32 scales [E, 1, F] / [E, 1, D], one
// per output column) and repro/kernels/expert_mlp_quant.py::
// expert_mlp_quant_kernel (kernel 3: kernel 5's int8 function over the
// capacity buffer, below).  The same function as grouped_mlp.cu, whose
// CUDA-core kernels keep f32 activations and the shapes this file does not
// take (the wrappers' static rule, kernels/expert_mlp_grouped.py::kernel_variant):
//
//     out[t] = (silu(x . wg[e]) * (x . wi[e])) . wo[e]    for each live tile t, e = te[t]
//
// products accumulated in f32, the activation rounded to bf16 before the
// down-projection, the output summed in f32 over all of F; rows of tiles at
// or past rows_used come out zero.
//
// Bound.  At every served shape the function is bytes-bound: it must read
// the weights of every expert its live tiles touch (3 D F values, bf16 2
// bytes, int8 1, int4 1/2), and does 2 rows 3 D F operations; even a
// 16384-token prefill (about 128 rows per expert) needs 4.2 ms of bf16
// operations against 9.6 ms of weight bytes on an H100.  Three things the
// CUDA-core kernels did kept them far from that bound; the design answers
// each:
//
// 1. Runs: one weight stream per run of tiles.  The dispatch sorts tiles by
//    expert, so neighbouring tiles share weights.  A first launch (runs_kernel,
//    one block, a block-wide scan of te) cuts the live tiles [0, rows_used / 8)
//    into runs of at most R consecutive tiles of one expert, in order: a
//    run is its first tile and its end (one past its last), so a run table
//    can also skip tiles (the capacity layout below); here each run ends
//    where the next starts, which the passes read (run_of) in place of the
//    ends the table also carries.  Any te fits the table's 2 n_tiles + 2
//    entries (the layout: runs_kernel's note).  Dead tiles past rows_used (te
//    clamped to E-1) join no run; the launch's other blocks write their output
//    rows' zeros.  The grid has max_runs_of rows, a static bound on the run
//    count of the dispatch's buffers (each expert adds at most one partial run,
//    and each run holds at least one of the T K assignments); row y takes runs
//    y, y + max_runs, ..., so a te that breaks the bound is still computed
//    whole, and at the dispatch's every block takes one run or none.
//    Everything stays on the device, so a CUDA graph can capture the
//    launches.  A block of the two passes takes one run and one block of
//    output columns, and loads each weight tile once for all the run's tiles.
//    Runs of one expert run as neighbouring blocks, so a second run's weights
//    mostly come from L2.
// 2. Tensor cores: mma.sync.m16n8k16, bf16 in, f32 accumulate, as
//    out^T = W^T . x^T: the weights are the m16 operand (16 output columns),
//    a tile's 8 token rows exactly the n8 operand, so no product is spent on
//    padding at decode.  The contraction order inside a 32-wide stage is
//    permuted (lane t of a quad takes contraction rows 8t .. 8t+7, read with
//    one 16-byte load of x), which the weight fragments follow; a sum does not
//    depend on it.  bf16 weights: ldmatrix.trans from the stage.  int8: each
//    lane reads 4 adjacent columns of a row (its fragment rows g and g+8 of
//    both m16 tiles are mapped to columns 4g .. 4g+3), pairs two rows' bytes
//    with one byte permute and widens four at once exactly (magic-number f32,
//    mma_sm90.cuh int8x4_to_bf16).  int4: a packed byte is exactly the
//    contraction pair a fragment register holds; nibbles are widened with
//    a byte permute, a mask and one bf16x2 subtract (128 + u - 136), exact.
//    The column scale multiplies the f32 sum once, (x . q) * s, and not each
//    weight as the plain version's x . bf16(q * s) does.  Held on the card
//    against the function in f64 on the exact weights q * s, this order came
//    closer than the plain version at every shape measured (PERF.md).
// 3. Bytes in flight: the block's threads stream its weight and x stages with
//    16-byte cp.async into a ring of S shared-memory stages (3-16, by format
//    and plan), S - 1 of them in flight; one barrier a stage frees a slot
//    and waits for no copy.  The ring's rows are swizzled so ldmatrix and the
//    widening reads hit distinct banks.
//
// The plans (launch_plan; the wrapper's mma_plan picks one from the shapes):
// 0, groups of about one tile (decode, a 256-token prefill): runs of one
// tile, blocks of 8 warps over 256 columns, a 108 KB ring; measured on the
// card it beat blocks of 2 warps over 64 columns (28 KB rings) and splitting
// the contraction across a block's warps.  On grids of at most 15 rows
// (decode at up to 8 tokens) the down pass's contraction (F: 256 stages at
// llama4's width) is split across 3 blocks, 4 for int4 (the wrapper's
// mma_plan), merged in a fixed order by merge_splits: at T = 4 that is 128
// up/gate and 240-320 down blocks where it was 128 and 80.  Splitting the
// up/gate pass too measured no faster.
// 1, bf16 weights and groups of 64 rows or more (a 16384-token prefill): runs
// of 16 tiles, 4 column groups x 2 row groups of 8 tiles (128 accumulators a
// thread), a 160 KB ring: one stage's x serves four warps and its weights
// two, so each staged byte feeds about 87 operations.  2, the rest: runs of 8
// tiles, 8 column groups, a 108 KB ring.  What still bounds it (PERF.md, from
// patched builds): at decode int8 / int4, each block's own work per stage,
// not the bytes; at 16384 tokens, mma.sync's operand traffic through shared
// memory (the build without weight loads takes 20 of the 22.6 ms): wgmma,
// which reads its operands from shared memory once per warpgroup, is next.
//
// Kernel 3, the capacity layout: the buffer [E C, D] (C a multiple of 8)
// holds expert e's rows at [e C, e C + min(fill[e], C)), zeros after them,
// so it is the grouped layout with every group padded to C and its tiles
// t -> t / tpe (tpe = C / 8 tiles an expert; no te array).  A first launch
// (capacity_runs_kernel) cuts each expert's live tiles [e tpe, e tpe +
// ceil(min(fill[e], C) / 8)) into runs of at most R, in expert order (a scan
// over E of each expert's run count), and its other blocks write the zeros
// of every expert's rows past its live tiles; fill is read on the device,
// so nothing waits for the host.  Rows of a live tile past fill are zero on
// input and come out zero through the products.  The grid's rows bound the
// runs by min(E ceil(tpe / R), n_assign): each run holds at least one filled
// row, and the rows hold at most the n_assign = T K assignments the wrapper
// is told of (the MoE layer's static T K).  At decode (T = 4, C = 8) that is
// 4 rows, so the down pass splits as kernel 5's does.  Same passes, plans
// and numerics as kernels 4 / 5.
//
// Two passes, as before: up/gate writes act [Ct, F] (bf16) and the down pass
// reads it (the round trip is Ct F 2 bytes each way, small beside the
// weights).  Deterministic: no atomics, every sum in one order.
#include "mma_sm90.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::int8x4_to_bf16;
using sm90::ldmatrix_x4_trans;
using sm90::mma_bf16;
using sm90::smem_u32;

constexpr int TILE = 8;    // token rows per tile == GROUPED_TILE
constexpr int KC = 32;     // contraction rows per stage
constexpr int WN = 32;     // output columns per warp: two m16 tiles
constexpr int XB = TILE * KC * 2;  // bytes of one tile's x in a stage
constexpr int SCAN = 1024;  // threads of the run-table block
constexpr int ZERO_BLOCKS = 32;  // blocks of runs_kernel that zero dead rows

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes global -> shared through L1 (x: the block's warps read the same rows).
__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// One matrix's stage in a warp's ring: ROWS stored rows of the warp's 32
// columns (int4: 16 byte rows of 32 columns hold 32 contraction rows).
template <int BITS>
struct Fmt {
  static constexpr int ROWS = BITS == 4 ? KC / 2 : KC;
  static constexpr int ROWB = BITS == 0 ? WN * 2 : WN;  // bytes of a stored row
  static constexpr int BYTES = ROWS * ROWB;
  static constexpr int CPR = ROWB / 16;  // 16-byte chunks per row
  static constexpr int ELT = BITS == 0 ? 2 : 1;  // bytes per stored column entry
  // Byte offset of chunk ch of stored row k.  bf16: a 128-byte line holds 2
  // rows; the chunk index is XORed with (k / 8) % 4, so the 8 rows an
  // ldmatrix reads (k = 0, 1, 8, 9, 16, 17, 24, 25 plus a constant) fall in
  // 8 distinct 16-byte bank groups.  int8 / int4: a line holds 4 rows, whose
  // slots are permuted by (k / Q) % 4 (Q rows per lane group: 8, or 4 byte
  // rows), so the 4 rows a warp reads at once take 4 distinct 32-byte slots.
  __device__ __forceinline__ static int off(int k, int ch) {
    if constexpr (BITS == 0) {
      return k * 64 + ((ch ^ ((k >> 3) & 3)) << 4);
    } else {
      constexpr int SH = BITS == 8 ? 3 : 2;
      return (k >> 2) * 128 + (((k & 3) ^ ((k >> SH) & 3)) << 5) + (ch << 4);
    }
  }
};

// A block's shape: runs of R tiles; WC x WR warps, WC column groups of 32
// output columns, WR row groups of R / WR tiles; a ring of at most RING
// bytes (at least 3 stages).
template <int R_, int WC_, int WR_, int RING_>
struct Plan {
  static constexpr int R = R_, WC = WC_, WR = WR_, RING = RING_;
  static constexpr int WARPS = WC * WR, THREADS = WARPS * 32, BN = WC * WN;
  static constexpr int RW = R / WR;  // tiles of one warp
  static_assert(R % WR == 0, "row groups split the run's tiles evenly");
};

// The ring of one pass: NW weight matrices (2: up/gate, 1: down).  A stage
// holds KC contraction rows of the block's WC * 32 columns of every matrix
// and of the run's x.
template <int BITS, int NW, class P>
struct Ring {
  static constexpr int WBYTES = NW * P::WC * Fmt<BITS>::BYTES;
  static constexpr int STAGE = WBYTES + P::R * XB;
  static constexpr int S_RAW = P::RING / STAGE;
  static constexpr int S = S_RAW < 3 ? 3 : (S_RAW > 16 ? 16 : S_RAW);
  static constexpr int BYTES = S * STAGE;
};

// Issue one stage's copies, every thread of the block a share: KC
// contraction rows of the block's columns of each matrix (a row's 16-byte
// chunks across the column groups on neighbouring threads), and the run's
// x rows [8 nrt, KC) at contraction kstep * KC.
template <int BITS, int NW, class P>
__device__ __forceinline__ void load_stage(uint8_t* st, const uint8_t* const* w, size_t ldw,
                                           const __nv_bfloat16* x, int K, int nrt, int kstep,
                                           int tid) {
  using Fm = Fmt<BITS>;
  constexpr int CH = Fm::ROWS * P::WC * Fm::CPR;
  const size_t row0 = (size_t)kstep * Fm::ROWS;
#pragma unroll
  for (int m = 0; m < NW; ++m) {
#pragma unroll
    for (int c0 = 0; c0 < CH; c0 += P::THREADS) {
      const int c = c0 + tid;
      if (CH % P::THREADS == 0 || c < CH) {
        const int ch = c % Fm::CPR, grp = (c / Fm::CPR) % P::WC, k = c / (Fm::CPR * P::WC);
        cp_async16(st + (m * P::WC + grp) * Fm::BYTES + Fm::off(k, ch),
                   w[m] + (row0 + k) * ldw + grp * Fm::ROWB + ch * 16, true);
      }
    }
  }
  uint8_t* xs = st + NW * P::WC * Fm::BYTES;
  for (int c = tid; c < nrt * 32; c += P::THREADS) {
    const int r = c >> 5, row = (c >> 2) & 7, ch = c & 3;
    cp_async16_ca(xs + r * XB + row * 64 + ch * 16,
                  x + (size_t)(r * TILE + row) * K + kstep * KC + ch * 8);
  }
}

// A fragments of one stage: a[m][i][s] for matrix m (at ws + m * mstride),
// m16 tile i (output columns), k-step s.  Fragment k 2t, 2t+1 (register 0,
// 1) of step s is contraction row 8t + 4s + {0, 1} of the stage, fragment
// k 2t+8, 2t+9 (registers 2, 3) rows 8t + 4s + {2, 3}; x's fragments follow
// the same order.  Columns: bf16, fragment row g of tile i is column 16i + g,
// g + 8 column 16i + g + 8; int8 / int4, g is column 4g + 2i and g + 8
// column 4g + 2i + 1 of the warp's 32.
template <int BITS, int NW>
__device__ __forceinline__ void fragments(const uint8_t* ws, int mstride, int lane,
                                          uint32_t (&a)[NW][2][2][4]) {
  using Fm = Fmt<BITS>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < NW; ++m) {
    const uint8_t* wm = ws + m * mstride;
    if constexpr (BITS == 0) {
      // lane 8 * mat + rho gives row rho of matrix mat: mat & 1 the column
      // half (a[1], a[3]), mat >> 1 the contraction half (a[2], a[3])
      const int mat = lane >> 3, rho = lane & 7;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int k = 8 * (rho >> 1) + 4 * s + (rho & 1) + 2 * (mat >> 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) ldmatrix_x4_trans(a[m][i][s], wm + Fm::off(k, 2 * i + (mat & 1)));
      }
    } else if constexpr (BITS == 8) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t w[4];  // rows 8t + 4s + j, columns 4g .. 4g+3
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] = *reinterpret_cast<const uint32_t*>(wm + Fm::off(8 * t + 4 * s + j, g >> 2) + 4 * (g & 3));
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows (2h, 2h + 1): registers 2h (column g), 2h + 1 (g + 8)
          int8x4_to_bf16(__byte_perm(w[2 * h], w[2 * h + 1], 0x5140), a[m][0][s][2 * h], a[m][0][s][2 * h + 1]);
          int8x4_to_bf16(__byte_perm(w[2 * h], w[2 * h + 1], 0x7362), a[m][1][s][2 * h], a[m][1][s][2 * h + 1]);
        }
      }
    } else {
      const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                     __ushort_as_bfloat16(0x4308));  // 136
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // byte row 4t + 2s + h: contraction rows 8t + 4s + 2h, +1
          const uint32_t q = *reinterpret_cast<const uint32_t*>(
              wm + Fm::off(4 * t + 2 * s + h, g >> 2) + 4 * (g & 3));
          const uint32_t u = q ^ 0x88888888u;  // each nibble v as v + 8 in [0, 16)
          const uint32_t v = u >> 4;           // byte c's high nibble in its low bits
#pragma unroll
          for (int c = 0; c < 4; ++c) {  // column 4g + c: tile c / 2, fragment row g + 8 (c % 2)
            const uint32_t y = __byte_perm(u, v, 0x4400 + 0x1111 * c);  // byte c of u and of v
            uint32_t r = (y & 0x000F000Fu) | 0x43004300u;  // bf16 pair 128 + u_lo, 128 + u_hi
            __nv_bfloat162 b = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r), bias);
            a[m][c >> 1][s][2 * h + (c & 1)] = *reinterpret_cast<uint32_t*>(&b);
          }
        }
      }
    }
  }
}

// Output column (within the warp's 32) of accumulator register q (0..3:
// rows g, g, g + 8, g + 8) of m16 tile i.
template <int BITS>
__device__ __forceinline__ int column(int i, int q, int g) {
  if constexpr (BITS == 0) return 16 * i + g + 8 * (q >> 1);
  else return 4 * g + 2 * i + (q >> 1);
}

// Run n of a table over nt tiles, in the layout CAP: its first tile, its
// end and its expert.  The grouped layout's runs end where the next starts
// and take their expert from te; the capacity layout's (CAP) read their ends
// and take expert t0 / tpe.  A template argument, so kernels 4 / 5 read no
// more than they did before the capacity layout.
template <bool CAP>
__device__ __forceinline__ void run_of(const int32_t* runs, int nt, int n, const int32_t* te,
                                       int tpe, int& t0, int& end, size_t& e) {
  t0 = runs[n];
  if constexpr (CAP) {
    end = runs[nt + 1 + n];
    e = (size_t)(t0 / tpe);
  } else {
    end = runs[n + 1];
    e = (size_t)te[t0];
  }
}

// One pass over a block of output columns for the runs of blockIdx.y,
// blockIdx.y + gridDim.y, ...  NW = 2: up/gate, y is act [Ct, N = F] =
// bf16(silu(x . w1 * s1) * (x . w0 * s0)); NW = 1: down, y is out [Ct, N = D]
// = bf16(x . w0 * s0).  Scales only for the quantized formats.  Warp (wc, wr)
// takes column group wc and tiles wr * RW .. of the run.  The down pass may
// split its contraction: with gridDim.z = split > 1, block z sums stages
// [z nk / split, (z + 1) nk / split) of its first run into f32 partials,
// part[z gridDim.y + run] (R TILE rows of N each), which merge_splits adds in
// the order of z; a later run of the block (only when te holds more runs
// than the grid's rows) is summed whole by the z = 0 block.  CAP: the
// capacity layout (run_of).
template <int BITS, int NW, class P, bool CAP>
__global__ void __launch_bounds__(P::THREADS)
mma_pass(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ runs, int n_tiles,
         const int32_t* __restrict__ te, int tpe, const void* __restrict__ w0,
         const float* __restrict__ s0,
         const void* __restrict__ w1, const float* __restrict__ s1, __nv_bfloat16* __restrict__ y,
         float* __restrict__ part, int K, int N) {
  using Fm = Fmt<BITS>;
  using Rg = Ring<BITS, NW, P>;
  constexpr int RW = P::RW, WC = P::WC;
  const int n_runs = runs[2 * n_tiles + 1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wc = warp % WC, r0 = (warp / WC) * RW;  // this warp's first tile of a run
  const int bcol = blockIdx.x * WC * WN, col0 = bcol + wc * WN;
  const int nk = K / KC, split = gridDim.z, z = blockIdx.z;
  const size_t ldw = (size_t)N * Fm::ELT;
  const size_t per_expert = (size_t)(K / (BITS == 4 ? 2 : 1)) * ldw;
  extern __shared__ __align__(128) uint8_t ring[];

#pragma unroll 1
  for (int run = blockIdx.y; run < n_runs; run += gridDim.y) {
    const bool partial = NW == 1 && split > 1 && run < gridDim.y;
    if (z > 0 && !partial) break;
    int t0, end;
    size_t e;
    run_of<CAP>(runs, n_tiles, run, te, tpe, t0, end, e);
    const int nrt = end - t0;
    const int nw = min(RW, nrt - r0);  // this warp's tiles of the run
    const int k0 = partial ? z * nk / split : 0;
    const int nks = (partial ? (z + 1) * nk / split : nk) - k0;
    const uint8_t* w[NW];
    w[0] = static_cast<const uint8_t*>(w0) + e * per_expert + (size_t)bcol * Fm::ELT;
    if constexpr (NW == 2) w[1] = static_cast<const uint8_t*>(w1) + e * per_expert + (size_t)bcol * Fm::ELT;
    const __nv_bfloat16* xr = x + (size_t)t0 * TILE * K;

    float acc[RW][NW][2][4];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int m = 0; m < NW; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][m][i][q] = 0.f;

#pragma unroll 1
    for (int p = 0; p < Rg::S - 1; ++p) {
      if (p < nks) load_stage<BITS, NW, P>(ring + p * Rg::STAGE, w, ldw, xr, K, nrt, k0 + p, tid);
      cp_async_commit();
    }
    int slot = 0, fill = Rg::S - 1;  // ring slot of stage i, and of stage i + S - 1
#pragma unroll 1
    for (int i = 0; i < nks; ++i) {
      // Stage i has landed (this thread's copies; the barrier makes every
      // thread's visible), and every warp is done with stage i - 1, whose slot
      // the next copies fill.  The barrier waits for no copy: the next S - 2
      // stages stay in flight.
      cp_async_wait<Rg::S - 2>();
      __syncthreads();
      if (i + Rg::S - 1 < nks)
        load_stage<BITS, NW, P>(ring + fill * Rg::STAGE, w, ldw, xr, K, nrt, k0 + i + Rg::S - 1, tid);
      cp_async_commit();
      if (nw > 0) {
        const uint8_t* st = ring + slot * Rg::STAGE;
        uint32_t a[NW][2][2][4];
        fragments<BITS, NW>(st + wc * Fm::BYTES, WC * Fm::BYTES, lane, a);
        const uint8_t* xs = st + Rg::WBYTES + r0 * XB + g * 64 + t * 16;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          if (r >= nw) break;
          const uint4 xv = *reinterpret_cast<const uint4*>(xs + r * XB);  // x[row g][8t .. 8t+7]
          const uint32_t b[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int m = 0; m < NW; ++m)
#pragma unroll
              for (int j = 0; j < 2; ++j) mma_bf16(acc[r][m][j], a[m][j][s], b[2 * s], b[2 * s + 1]);
        }
      }
      slot = slot + 1 == Rg::S ? 0 : slot + 1;
      fill = fill + 1 == Rg::S ? 0 : fill + 1;
    }
    cp_async_wait<0>();

    if (partial) {  // the f32 sums of this split, unscaled
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (r >= nw) break;
        float* pr = part + ((size_t)z * gridDim.y + run) * (P::R * TILE) * N +
                    (size_t)((r0 + r) * TILE + 2 * t) * N + col0;
#pragma unroll
        for (int b = 0; b < 2; ++b) {  // token row 2t + b of tile r
          if constexpr (BITS == 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) pr[b * N + column<BITS>(i, 2 * h, g)] = acc[r][0][i][2 * h + b];
          } else {  // columns 4g .. 4g+3: (tile 0, g), (0, g + 8), (1, g), (1, g + 8)
            *reinterpret_cast<float4*>(pr + b * N + 4 * g) = make_float4(
                acc[r][0][0][b], acc[r][0][0][2 + b], acc[r][0][1][b], acc[r][0][1][2 + b]);
          }
        }
      }
    } else {
      // Epilogue: column scales (quantized formats), SwiGLU (up/gate), bf16.
      float sc[NW][2][2];  // [matrix][tile][fragment row g, g + 8]
#pragma unroll
      for (int m = 0; m < NW; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if constexpr (BITS == 0) {
              sc[m][i][h] = 1.f;
            } else {
              const float* s = m == 0 ? s0 : s1;
              sc[m][i][h] = __ldg(s + e * N + col0 + column<BITS>(i, 2 * h, g));
            }
          }
      __nv_bfloat16* yr = y + ((size_t)t0 + r0) * TILE * N + col0;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        if (r >= nw) break;
        float v[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float h0 = acc[r][0][i][q] * sc[0][i][q >> 1];
            if constexpr (NW == 2) {
              const float gv = acc[r][NW - 1][i][q] * sc[NW - 1][i][q >> 1];
              v[i][q] = gv / (1.f + expf(-gv)) * h0;
            } else {
              v[i][q] = h0;
            }
          }
#pragma unroll
        for (int b = 0; b < 2; ++b) {  // token row 2t + b of tile r
          __nv_bfloat16* yrow = yr + (size_t)(r * TILE + 2 * t + b) * N;
          if constexpr (BITS == 0) {
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int h = 0; h < 2; ++h) yrow[column<BITS>(i, 2 * h, g)] = __float2bfloat16(v[i][2 * h + b]);
          } else {  // columns 4g .. 4g+3: (tile 0, g), (0, g + 8), (1, g), (1, g + 8)
            uint2 pk;
            pk.x = sm90::pack_bf16(v[0][b], v[0][2 + b]);
            pk.y = sm90::pack_bf16(v[1][b], v[1][2 + b]);
            *reinterpret_cast<uint2*>(yrow + 4 * g) = pk;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the ring before the next run's copies
  }
}

// The split down pass's epilogue: for each run slot of the grid (gridDim.y
// of the pass), the partials of its rows summed over z = 0 .. split - 1 in
// that order, times the column scales (null for bf16 weights), to bf16.
// Threads take 4 adjacent columns of a row.
template <bool CAP>
__global__ void __launch_bounds__(256)
merge_splits(const float* __restrict__ part, const int32_t* __restrict__ runs, int n_tiles,
             const int32_t* __restrict__ te, int tpe, const float* __restrict__ scale,
             __nv_bfloat16* __restrict__ y, int N, int run_rows, int split) {
  const int run = blockIdx.y;
  if (run >= runs[2 * n_tiles + 1]) return;
  int t0, end;
  size_t e;
  run_of<CAP>(runs, n_tiles, run, te, tpe, t0, end, e);
  const int rows = (end - t0) * TILE, nq = N / 4;
  const size_t stride = (size_t)gridDim.y * run_rows * N;  // between splits' partials
  const float* p = part + (size_t)run * run_rows * N;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < rows * nq; u += gridDim.x * blockDim.x) {
    const int row = u / nq, c = (u - row * nq) * 4;
    float a[4] = {};
    for (int zz = 0; zz < split; ++zz) {
      const float4 v = *reinterpret_cast<const float4*>(p + zz * stride + (size_t)row * N + c);
      a[0] += v.x;
      a[1] += v.y;
      a[2] += v.z;
      a[3] += v.w;
    }
    if (scale)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] *= __ldg(scale + e * N + c + j);
    uint2 pk;
    pk.x = sm90::pack_bf16(a[0], a[1]);
    pk.y = sm90::pack_bf16(a[2], a[3]);
    *reinterpret_cast<uint2*>(y + (size_t)(t0 * TILE + row) * N + c) = pk;
  }
}

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};

// Inclusive scan of v over the block (whole warps; starts and ends on a barrier).
template <typename Op>
__device__ int block_scan(int v, int* tmp, Op op, int ident) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = op(v, u);
  }
  __syncthreads();
  if (lane == 31) tmp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? tmp[lane] : ident;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = op(w, u);
    }
    if (lane < nw) tmp[lane] = w;
  }
  __syncthreads();
  return warp > 0 ? op(v, tmp[warp - 1]) : v;
}

// A run table of nt tiles has 2 nt + 2 entries: runs[n] the first tile of
// run n, runs[n_runs] the live tile count, runs[nt + 1 + n] the end of run n
// (one past its last tile), runs[2 nt + 1] = n_runs.  n_runs <= live <= nt,
// so whatever te or fill holds the table fits.
//
// runs_kernel, block 0: the grouped layout's table.  Tile j < live starts a
// run when it is the (multiple of R)-th tile of its expert's group, the
// group starting at the last tile j' <= j with te[j'] != te[j' - 1]; a run
// ends where the next starts (the last at live).  Other blocks: zeros in the
// output rows [8 live, Ct) (D % 8 == 0), which no run writes.
__global__ void __launch_bounds__(SCAN)
runs_kernel(const int32_t* __restrict__ te, const int32_t* __restrict__ rows_used, int nt, int R,
            int32_t* __restrict__ runs, __nv_bfloat16* __restrict__ out, int D, int Ct) {
  const int live = min(__ldg(rows_used) / TILE, nt);
  if (blockIdx.x > 0) {
    uint4* o = reinterpret_cast<uint4*>(out);
    const size_t lo = (size_t)live * TILE * D / 8, hi = (size_t)Ct * D / 8;
    for (size_t u = lo + (size_t)(blockIdx.x - 1) * blockDim.x + threadIdx.x; u < hi;
         u += (size_t)(gridDim.x - 1) * blockDim.x)
      o[u] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  __shared__ int tmp[32];
  int group = 0, n = 0;  // carried across chunks: the group start of the last tile, runs so far
  for (int base = 0; base < live; base += blockDim.x) {
    const int j = base + threadIdx.x;
    const bool in = j < live;
    const int ej = in ? __ldg(te + j) : -1;
    const bool first = in && (j == 0 || __ldg(te + j - 1) != ej);
    const int gs = max(block_scan(first ? j : -1, tmp, Max(), -1), group);
    const bool start = in && (j - gs) % R == 0;
    const int upto = block_scan(start ? 1 : 0, tmp, Sum(), 0);
    if (start) runs[n + upto - 1] = j;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) {
      tmp[0] = gs;
      tmp[1] = n + upto;
    }
    __syncthreads();
    group = tmp[0];
    n = tmp[1];
  }
  if (threadIdx.x == 0) {
    runs[n] = live;
    runs[2 * nt + 1] = n;
  }
  __syncthreads();  // the starts (global, this block's) visible to every thread
  for (int i = threadIdx.x; i < n; i += blockDim.x) runs[nt + 1 + i] = runs[i + 1];
}

// capacity_runs_kernel, block 0: the capacity layout's table (tpe tiles an
// expert).  Expert e has L_e = ceil(min(fill[e], C) / 8) live tiles from
// e tpe, cut into ceil(L_e / R) runs; a block-wide scan over the experts
// (chunks of the block's width, carried) places each expert's runs, in
// expert order.  Other blocks: zeros in each expert's rows past its live
// tiles, [e C + 8 L_e, (e + 1) C) (D % 8 == 0), which no run writes.
__global__ void __launch_bounds__(SCAN)
capacity_runs_kernel(const int32_t* __restrict__ fill, int E, int tpe, int R,
                     int32_t* __restrict__ runs, __nv_bfloat16* __restrict__ out, int D) {
  const int nt = E * tpe, C = tpe * TILE;
  auto live_tiles = [&](int e) { return (min(max(__ldg(fill + e), 0), C) + TILE - 1) / TILE; };
  if (blockIdx.x > 0) {
    const size_t row16 = D / 8;  // 16-byte words of a row
    for (int e = blockIdx.x - 1; e < E; e += gridDim.x - 1) {
      uint4* o = reinterpret_cast<uint4*>(out) + (size_t)e * C * row16;
      for (size_t u = (size_t)live_tiles(e) * TILE * row16 + threadIdx.x; u < (size_t)C * row16;
           u += blockDim.x)
        o[u] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  __shared__ int tmp[32];
  int n = 0, live = 0;  // carried across chunks: runs and live tiles so far
  for (int base = 0; base < E; base += blockDim.x) {
    const int e = base + threadIdx.x;
    const int L = e < E ? live_tiles(e) : 0, r = (L + R - 1) / R;
    const int upto = block_scan(r, tmp, Sum(), 0);
    const int lsum = block_scan(L, tmp, Sum(), 0);
    const int t0 = e * tpe;
    for (int i = 0, o = n + upto - r; i < r; ++i, ++o) {
      runs[o] = t0 + i * R;
      runs[nt + 1 + o] = t0 + min((i + 1) * R, L);
    }
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) {
      tmp[0] = n + upto;
      tmp[1] = live + lsum;
    }
    __syncthreads();
    n = tmp[0];
    live = tmp[1];
  }
  if (threadIdx.x == 0) {
    runs[n] = live;
    runs[2 * nt + 1] = n;
  }
}

// Lets a kernel take its ring in dynamic shared memory (past 48 KB); one
// attribute call per instantiation.
template <int BITS, int NW, class P, bool CAP>
int prepare() {
  static bool done = false;
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(mma_pass<BITS, NW, P, CAP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Ring<BITS, NW, P>::BYTES);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

// The grid's rows: a static bound on the run count of the dispatch's
// buffers.  There a run holds at least one live tile, a live tile at least
// one of the T K <= Ct - 7 E + 7 assignments, and each expert adds at most
// one partial run to ceil(n_tiles / R), since te groups each expert's
// tiles.  A te past that bound is still computed whole: a block then takes
// several runs.
int max_runs_of(int n_tiles, int E, int R) {
  int bound = (n_tiles + R - 1) / R + E;
  if (n_tiles < bound) bound = n_tiles;
  const int assignments = n_tiles * TILE - (TILE - 1) * E + TILE - 1;
  if (assignments < bound) bound = assignments;
  return bound < 1 ? 1 : bound;
}

// The same over the capacity layout: at most ceil(tpe / R) runs an expert,
// and, with n_assign > 0 assignments, at most n_assign runs (each run holds
// a filled row).  A fill past that bound is still computed whole.
int capacity_max_runs_of(int E, int tpe, int R, int n_assign) {
  int bound = E * ((tpe + R - 1) / R);
  if (n_assign > 0 && n_assign < bound) bound = n_assign;
  return bound < 1 ? 1 : bound;
}

// Blocks of merge_splits for one run slot: 4 columns a thread.
int merge_blocks(int R, int N) {
  const int quads = R * TILE * N / 4;
  return (quads + 255) / 256;
}

// One call's arguments: the grouped layout (te, rows_used; tpe 0) or the
// capacity layout (CAP: fill, tpe = C / 8, n_assign; te null).
struct Call {
  const void *x, *te, *rows_used, *fill, *wi, *wi_s, *wg, *wg_s, *wo, *wo_s;
  void *act, *out, *runs, *part;
  int n_tiles, E, D, F, tpe, n_assign, split;
  cudaStream_t s;
};

template <int BITS, class P, bool CAP>
int launch(const Call& c) {
  const int D = c.D, F = c.F, split = c.split;
  if (D % P::BN || F % P::BN || D % KC || F % KC || c.n_tiles < 1 || c.E < 1 || split < 1 ||
      split > F / KC || (split > 1 && c.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* r = static_cast<int32_t*>(c.runs);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(c.out);
  int max_runs;
  if constexpr (CAP) {
    max_runs = capacity_max_runs_of(c.E, c.tpe, P::R, c.n_assign);
    capacity_runs_kernel<<<1 + ZERO_BLOCKS, SCAN, 0, c.s>>>(static_cast<const int32_t*>(c.fill), c.E,
                                                            c.tpe, P::R, r, o, D);
  } else {
    max_runs = max_runs_of(c.n_tiles, c.E, P::R);
    runs_kernel<<<1 + ZERO_BLOCKS, SCAN, 0, c.s>>>(static_cast<const int32_t*>(c.te),
                                                   static_cast<const int32_t*>(c.rows_used),
                                                   c.n_tiles, P::R, r, o, D, c.n_tiles * TILE);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = prepare<BITS, 2, P, CAP>();
  if (rc) return rc;
  rc = prepare<BITS, 1, P, CAP>();
  if (rc) return rc;
  const int32_t* t = static_cast<const int32_t*>(c.te);
  const float* so = static_cast<const float*>(c.wo_s);
  __nv_bfloat16* a = static_cast<__nv_bfloat16*>(c.act);
  mma_pass<BITS, 2, P, CAP><<<dim3(F / P::BN, max_runs), P::THREADS, Ring<BITS, 2, P>::BYTES, c.s>>>(
      static_cast<const __nv_bfloat16*>(c.x), r, c.n_tiles, t, c.tpe, c.wi,
      static_cast<const float*>(c.wi_s), c.wg, static_cast<const float*>(c.wg_s), a, nullptr, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* pt = static_cast<float*>(c.part);
  mma_pass<BITS, 1, P, CAP>
      <<<dim3(D / P::BN, max_runs, split), P::THREADS, Ring<BITS, 1, P>::BYTES, c.s>>>(
          a, r, c.n_tiles, t, c.tpe, c.wo, so, nullptr, nullptr, o, pt, F, D);
  if (split > 1)
    merge_splits<CAP><<<dim3(merge_blocks(P::R, D), max_runs), 256, 0, c.s>>>(
        pt, r, c.n_tiles, t, c.tpe, so, o, D, P::R * TILE, split);
  return static_cast<int>(cudaGetLastError());
}

// The plans of the note above: 0, 1 (bf16 weights only) and 2.
template <int BITS, bool CAP>
int launch_plan(const Call& c, int plan) {
  if (plan == 0) return launch<BITS, Plan<1, 8, 1, 110592>, CAP>(c);
  if constexpr (BITS == 0) {
    if (plan == 1) return launch<BITS, Plan<16, 4, 2, 163840>, CAP>(c);
  }
  if (plan == 2) return launch<BITS, Plan<8, 8, 1, 110592>, CAP>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers: xg
// [Ct, D] bf16, te [Ct/8] and rows_used [1] int32, the weights (bits 0: bf16;
// 8: int8; 4: packed int4) with f32 scales for bits 8 and 4 (null for 0), act
// [Ct, F] and out [Ct, D] bf16 allocated by the caller, runs an int32
// workspace of 2 n_tiles + 2 entries, plan one of launch_plan's, split the
// blocks that share the down pass's contraction (1 to F / 32), part an f32
// workspace of split D max_runs R 8 entries when split > 1 (max_runs_of,
// with the plan's R; else null); stream a cudaStream_t.  D and F must be multiples of
// the plan's block width (256 or 128 columns).  Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" {

int grouped_mlp_mma(const void* xg, const void* te, const void* rows_used, const void* wi,
                    const void* wi_s, const void* wg, const void* wg_s, const void* wo,
                    const void* wo_s, void* act, void* out, void* runs, void* part, int n_tiles,
                    int E, int D, int F, int bits, int plan, int split, void* stream) {
  const Call c{xg, te, rows_used, nullptr, wi, wi_s, wg, wg_s, wo, wo_s, act, out, runs, part,
               n_tiles, E, D, F, 0, 0, split, static_cast<cudaStream_t>(stream)};
  if (bits == 0) return launch_plan<0, false>(c, plan);
  if (bits == 8) return launch_plan<8, false>(c, plan);
  if (bits == 4) return launch_plan<4, false>(c, plan);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel 3 over the capacity buffer xe [E, C, D] (C a multiple of 8), int8
// weights with their scales: fill [E] int32 (rows at or past fill[e] are
// zero; any value, the gating kernel's counts included), n_assign the
// assignments the buffer can hold at most (T K; 0 if unknown), act [E C, F],
// out [E, C, D], runs 2 E C / 8 + 2 entries, part as above with
// capacity_max_runs_of's bound; plan 0 or 2.
int expert_mlp_mma(const void* xe, const void* fill, const void* wi, const void* wi_s,
                   const void* wg, const void* wg_s, const void* wo, const void* wo_s, void* act,
                   void* out, void* runs, void* part, int E, int C, int D, int F, int n_assign,
                   int plan, int split, void* stream) {
  if (C < TILE || C % TILE) return static_cast<int>(cudaErrorInvalidValue);
  const Call c{xe, nullptr, nullptr, fill, wi, wi_s, wg, wg_s, wo, wo_s, act, out, runs, part,
               E * (C / TILE), E, D, F, C / TILE, n_assign, split, static_cast<cudaStream_t>(stream)};
  return launch_plan<8, true>(c, plan);
}

// The run tables alone (what the first launch writes into runs, 2 n_tiles
// + 2 entries), for checking them against their plain versions.
int grouped_mlp_runs(const void* te, const void* rows_used, void* runs, int n_tiles, int R,
                     void* stream) {
  if (n_tiles < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  runs_kernel<<<1, SCAN, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(te), static_cast<const int32_t*>(rows_used), n_tiles, R,
      static_cast<int32_t*>(runs), nullptr, 0, n_tiles * TILE);
  return static_cast<int>(cudaGetLastError());
}

int expert_mlp_mma_runs(const void* fill, void* runs, int E, int C, int R, void* stream) {
  if (E < 1 || C < TILE || C % TILE || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  capacity_runs_kernel<<<1, SCAN, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fill), E, C / TILE, R, static_cast<int32_t*>(runs), nullptr, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
