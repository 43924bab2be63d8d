// Flash attention for Hopper, sm_90a: the static prefill and the
// teacher-forced forward over contiguous q / k / v.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (its pallas_call), kernel 6: online-softmax attention with f32 running
// max, normaliser and accumulator, output in the input type.  It computes
// that kernel's function, extended to what the model's attend_full needs:
//
//   q [B, S, H, dh], k / v [B, T, Hkv, dh] (the model's layouts, read in
//   place), G = H / Hkv query heads per kv-head (head h reads kv-head h / G),
//   q_pos [B, S] and k_pos [B, T] int32 absolute positions
//   -> out [B, S, H, dh]
//
// with the masks of paged_attention.cuh's Mask: k_pos >= 0, causal
// k_pos <= q_pos, window q_pos - k_pos < window; scores scaled, then
// softcapped (cap * tanh(s / cap)), then masked, as the model's _sdpa does.
// The TPU kernel's own contract (q [BH, S, dh], causal by index, top-left
// aligned) is the case H = Hkv = 1, q_pos = arange(S), k_pos = arange(T),
// which the wrapper builds.  Masked entries get probability 0 explicitly,
// so a row with no valid key gives 0 (as kernels 7-9); every static or
// forward query sees itself, so the model never produces such a row.
//
// On the TPU the k-block grid axis runs in order and carries m, l and the
// accumulator in VMEM scratch; here one block owns a query tile and walks
// its K/V tiles in a loop, with m and l in registers.
//
// bf16, head dims 64, 128 and 256 (every served config: llama4-maverick
// and glm4-9b at 128, nlg-350m-moe128 at 64, recurrentgemma-2b at 256):
// warp-specialised wgmma with TMA.
//   * A block holds BM = 128 query rows of one head: two consumer
//     warpgroups of 64 rows each and one producer warpgroup, whose single
//     thread keeps K/V tiles of BN = 128 keys (64 at dh 256) in flight
//     through TMA (cp.async.bulk.tensor over 4-D tensor maps of the model's
//     layouts, read in place; 128-byte swizzle, a row as dh / 64 boxes of 64
//     columns; zero-filled past T), with the tile's key positions (a 1-D
//     map), into a ring of ST stages (2 at dh 128 and 256, 4 at 64).  K
//     (with the positions) and V each have a "full" mbarrier (TMA bytes) and an
//     "empty" one (one arrival per consumer warp): K is released when the
//     tile's softmax is done, V when its P V is, so the next K load starts a
//     product earlier.  setmaxnreg moves registers from the producer (24)
//     to the consumers (240).  A prefill of at most 64 tokens (the served
//     4 x 64), or one whose 128-row tiles would leave SMs idle (the
//     wrapper's q_tile_rows), takes blocks of one consumer warpgroup (64
//     rows) and 64-key tiles instead: half the shared memory, two blocks per
//     SM, the served prefill in one wave.
//   * S = Q K^T: wgmma m64n{BN}k16, Q (loaded once by TMA) and K from shared
//     memory.  The online softmax runs on the accumulators in registers
//     (each row's 4 threads a quad, as in mma.sync; exponentials as 2^x of
//     the log2-scaled scores), P is rounded to bf16 (as _sdpa casts its
//     probabilities to v's type) and packed in registers as the A operand of
//     O += P V: wgmma m64n{dh}k16 with V transposed from shared memory.  A
//     warpgroup issues tile j's S before tile j - 1's P V and runs tile j's
//     softmax while that P V is on the tensor cores (not at dh 256, below);
//     the two warpgroups of a block interleave on the tensor cores as they
//     come.  Masked entries
//     are set to -inf before the exponential, so they get probability
//     exactly 0 (the running max stays finite).
//   * Live and full tiles: a block marks the tiles that may hold a key
//     valid for one of its rows (never loaded otherwise) and those whose
//     every key is valid for every row (no per-entry mask there; a tile that
//     is not full is masked per entry from the positions TMA brought with
//     its K), while its query tile lands, from tile summaries (min and max
//     valid position and their count per 128 keys) that a first launch
//     writes once for all blocks of a row.  Every block reading the row's
//     positions instead (launch/attention_kernels.py --variants) was slower
//     at every prompt length measured, by about 6% at 16384 tokens.  A row
//     of at most 64 keys (the served 4 x 64 prefill) is one tile, which no
//     mark would skip or spare its mask: it takes neither the launch nor a
//     mark.
//   * Tensor maps are encoded on the host at every call (libcuda's
//     cuTensorMapEncodeTiled, reached through the runtime): a ring of
//     encoded maps kept by their arguments gave no host time that could be
//     read above the host's spread at the served 4 x 64 prefill.
//   * Query tiles are issued heaviest (last causal) first, all heads of one
//     query tile together (grid x = head), so the G heads of a kv-head read
//     the same K/V tiles from L2.
//   * Head dim 256 (recurrentgemma-2b, 10 heads over 1, window 2048): Q (64
//     KB, four boxes a row) stays in shared memory for the whole walk, and K
//     and V are two stages of 64-key tiles (64 KB each): about 195 KB a
//     block; a 64-key tile is marked from its 128-key summary.  It takes
//     128-row blocks at every S: the reason for 64-row blocks elsewhere, two
//     blocks to an SM, does not hold when one 64-row block needs 160 KB.
//     O += P V is one m64n256k16.  A consumer thread holds 128 f32 of O, 32
//     of S and 16 of packed P, so it runs a tile's S, softmax and P V in
//     turn (the two warpgroups overlap each other) rather than overlapping
//     its own softmax with the last tile's P V.  Every mbarrier wait is one
//     block of PTX (wgmma_sm90.cuh's mbar_wait_ptx): with the C++ polling
//     loop, ptxas serialised every wgmma of the kernel ("wgmma.mma_async
//     instructions are serialized due to program dependence on
//     compiler-inserted WG.DP in divergent path") and spilled 700 bytes a
//     thread.  ptxas reports the same serialisation for the dh 64 / 128
//     instances, which keep the loop they were measured with (PERF.md).
// Head dims 32 and 112 (no served config) keep the first design: one block
// of 4 warps per 64-row query tile on mma.sync m16n8k16, Q in registers as A
// fragments (ldmatrix), K/V tiles of 64 keys double-buffered with cp.async,
// the query tile staged in the second K buffer (three blocks to an SM), and
// the same position-driven marks computed by each block from the positions.
//
// f32 (reduced checks): plain FMA on CUDA cores (no TF32), the shared code
// of paged_attention.cuh walking the contiguous rows (16 query rows of one
// kv-head per block, key tiles of 32), as kernel 9 does.
//
// Training (kernel 6b's input, flash_attention_bwd.cu): an optional output L
// [B, H, S], the row log-sum-exp of the scaled (softcapped) scores over the
// valid keys, natural log (+inf for a row with none).  The wgmma and
// mma.sync paths write it from an instance of their own (template LSE), so
// the serving launch (a null L) runs the code it ran before; the f32 path
// writes it after its store.
//
// Causal and window skip: before its loop, a block reads the key
// positions of its batch row once and marks the key tiles that hold a key
// valid for at least one of its rows (k_pos >= 0, k_pos <= its largest
// query position, k_pos > its smallest query position - window); the loop
// walks the marked tiles only, so tiles above the causal frontier (or
// before the window) are never loaded nor computed.  Skipping is exact: a
// fully masked tile leaves m, l and the accumulator unchanged.  It also
// marks the tiles whose every key is valid for every row (below the causal
// diagonal, inside the window), which skip the per-entry mask.  The f32 path
// skips dead tiles after reading their positions (tile_live).
//
// Bound: q, k, v and out are read or written once (2 bytes a value in bf16)
// plus the positions; 4 * H * dh operations per unmasked (query, key) pair
// (two products of 2 * dh each).  A causal prefill of S tokens does
// 2 * H * dh * S * (S + 1) operations against 2 * S * (H + Hkv) * dh * 2
// bytes: at S = 64 bytes bound it, past a few hundred tokens the tensor
// cores (989 TFLOP/s bf16).  What keeps the wgmma path from that rate, as
// measured on an H100 at 16384 causal tokens of llama4-maverick's heads
// (launch/attention_kernels.py --variants, PERF.md): built without its K/V
// loads and its softmax it still takes about 70% of its time, so the
// products' issue and waits set it (a warpgroup waits on its S before its
// softmax and on its P V before reusing a stage, and two warpgroups do not
// cover those waits); the softmax and the loads add the rest.  Strict
// turn-taking of the two warpgroups (named barriers), a kv-head-major
// block order, a third K/V stage and 192-row blocks over 64-key tiles were
// each slower or no faster.
#include <math.h>

#include "mma_sm90.cuh"
#include "paged_attention.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;    // query rows per bf16 block: 4 warps x 16
constexpr int BK = 64;    // keys per bf16 tile
constexpr int NW = 4;
constexpr int NT = NW * 32;
constexpr int MAX_TILE_WORDS = 128;  // live-tile bitmask: up to 128 * 32 tiles of BK keys
constexpr int RT = 16;               // f32 path: query rows per block
static_assert(BK / 8 * 4 == 32, "one bit of the validity mask per S accumulator of a thread");
static_assert(BQ == BK, "the query tile is staged in a K buffer");

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  const int* kpos;
  void* out;
  int B, S, T, H, Hkv, G;
  paged::Mask mk;
  float* lse;  // [B, H, S] row log-sum-exp (training: kernel 6b's input), or null
};

// ---------------------------------------------------------------------------
// bf16, head dims 32 and 112: mma.sync
// ---------------------------------------------------------------------------

template <int DH>
struct Smem16 {
  static_assert(DH <= 128, "a thread holds its Q fragments beside DH / 2 f32 accumulators");
  static constexpr int LD = DH + 8;  // padded row: ldmatrix rows on distinct banks
  // the query tile is staged in k[1] (BQ == BK): its fragments move to
  // registers before the second K/V tile is loaded there, which keeps the
  // block at 71 KB, three blocks to an SM
  bf16 k[2][BK][LD];
  bf16 v[2][BK][LD];
  int kp[2][BK];   // key positions of a tile, -1 past T
  int qp[BQ];      // query positions of the block
  unsigned live[MAX_TILE_WORDS];  // tiles that hold a key valid for some row
  unsigned full[MAX_TILE_WORDS];  // tiles whose every key is valid for every row
  int qp_lo, qp_hi;
};

// LSE: the instance that also writes the row log-sum-exp (training); the
// serving instance compiles without it
template <int DH, bool LSE>
__global__ void __launch_bounds__(NT, 3) flash_bf16_kernel(const Params p) {
  using Sm = Smem16<DH>;
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  constexpr int KS = DH / 16;  // k-steps of Q K^T; pairs of 8-wide dh tiles of P V
  constexpr int NS = BK / 8;   // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const int nT = (p.T + BK - 1) / BK;
  const bf16* Q = static_cast<const bf16*>(p.q);
  const bf16* K = static_cast<const bf16*>(p.k);
  const bf16* V = static_cast<const bf16*>(p.v);
  const int* kpos = p.kpos + (size_t)b * p.T;

  // the query tile (rows past S zero-filled, never stored) and its positions
  bf16(*qt)[Sm::LD] = s.k[1];
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8, sq = s0 + r;
    const bool ok = sq < p.S;
    cp_async16(&qt[r][c], Q + (ok ? (((size_t)b * p.S + sq) * p.H + h) * DH + c : 0), ok);
  }
  cp_async_commit();
  if (tid < BQ) s.qp[tid] = s0 + tid < p.S ? __ldg(p.qpos + (size_t)b * p.S + s0 + tid) : 0;
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < BQ && s0 + r < p.S; r += 32) {
      lo = min(lo, s.qp[r]);
      hi = max(hi, s.qp[r]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      s.qp_lo = lo;
      s.qp_hi = hi;
    }
  }
  __syncthreads();

  // mark the key tiles that hold a key valid for some row of the block, and
  // those whose every key is valid for every row (no per-entry mask there)
  mark_tiles<BK, 16>(kpos, p.T, s.qp_lo, s.qp_hi, p.mk.causal, p.mk.window, s.live, s.full,
                 MAX_TILE_WORDS);

  auto load_kv = [&](int j, int buf) {
    const int t0 = j * BK;
    for (int i = tid; i < BK * CH; i += NT) {
      const int r = i / CH, c = (i - r * CH) * 8, t = t0 + r;
      const bool ok = t < p.T;
      const size_t off = ok ? (((size_t)b * p.T + t) * p.Hkv + hk) * DH + c : 0;
      cp_async16(&s.k[buf][r][c], K + off, ok);
      cp_async16(&s.v[buf][r][c], V + off, ok);
    }
    if (tid < BK) s.kp[buf][tid] = t0 + tid < p.T ? __ldg(kpos + t0 + tid) : -1;
    cp_async_commit();
  };

  int j = next_live(s.live, 0, nT);
  if (j < nT) load_kv(j, 0);
  cp_async_wait_all();
  __syncthreads();

  // Q fragments for every k-step, once; then k[1] is free for the next tile
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], &qt[warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int qpr[2] = {s.qp[r0], s.qp[r0 + 8]};
  const int c0 = (lane & 3) * 2;           // this thread's first column in an 8-wide tile
  __syncthreads();                         // every warp holds its Q fragments
  float m[2] = {paged::NEG_INF, paged::NEG_INF};
  float l[2] = {0.f, 0.f};  // partial sums over this thread's columns
  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int buf = 0;
  while (j < nT) {
    const int jn = next_live(s.live, j + 1, nT);
    if (jn < nT) load_kv(jn, buf ^ 1);  // released by the barrier that ended the last tile

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &s.k[buf][np * 16 + (lane >> 4) * 8 + (lane & 7)][kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(sc[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale, softcap, mask; online softmax per row (a row's 4 threads are a quad)
    float mx[2] = {paged::NEG_INF, paged::NEG_INF};
    uint32_t valid = ~0u;  // bit n * 4 + e: entry sc[n][e] is unmasked (NS * 4 = 32 entries)
    if ((s.full[j >> 5] >> (j & 31)) & 1u) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = p.mk.score(sc[n][e]);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      }
    } else {
      valid = 0;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = s.kp[buf][n * 8 + c0 + (e & 1)];
          if (p.mk.valid(kp, qpr[e >> 1])) {
            valid |= 1u << (n * 4 + e);
            sc[n][e] = p.mk.score(sc[n][e]);
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
          }
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = __expf(m[i] - m_new);  // 1 while no valid key was seen, 0 below a new max
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pe = (valid >> (n * 4 + e)) & 1u ? __expf(sc[n][e] - m[i]) : 0.f;
        sc[n][e] = pe;
        l[i] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's accumulators, rounded to bf16, are the A fragments
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &s.v[buf][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][dp * 16 + (lane >> 4) * 8]);
        mma_bf16(o[2 * dp], a, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], a, vb[2], vb[3]);
      }
    }

    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... for every thread, and this one is consumed
    buf ^= 1;
    j = jn;
  }

  // normalise (a row with no valid key has l = 0 and o = 0: writes 0) and store
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int sq = s0 + r0 + 8 * i;
    if (sq >= p.S) continue;
    if (LSE && (lane & 3) == 0)
      p.lse[((size_t)b * p.H + h) * p.S + sq] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* row = out + (((size_t)b * p.S + sq) * p.H + h) * DH + c0;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) = pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int DH, bool LSE>
int launch_bf16_instance(const Params& p, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem16<DH>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_kernel<DH, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  flash_bf16_kernel<DH, LSE><<<dim3((p.S + BQ - 1) / BQ, p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
int launch_bf16(const Params& p, cudaStream_t stream) {
  return p.lse != nullptr ? launch_bf16_instance<DH, true>(p, stream)
                          : launch_bf16_instance<DH, false>(p, stream);
}

// ---------------------------------------------------------------------------
// bf16, head dims 64, 128 and 256: wgmma with TMA
// ---------------------------------------------------------------------------

constexpr int WBN = 128;  // keys per tile summary

// Per WBN keys of each of the B rows of kpos [B, T]: {min, max} of the
// valid positions (>= 0) and their count, keys past T invalid; an empty
// tile is {INT_MAX, INT_MIN, 0}.  One warp per tile, grid (ceil(nT / 8), B)
// of 256 threads.
__global__ void __launch_bounds__(256) tile_summary_kernel(const int* __restrict__ kpos,
                                                           int4* __restrict__ summ, int T, int nT) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * 8 + (threadIdx.x >> 5), b = blockIdx.y;
  if (j >= nT) return;
  const int* row = kpos + (size_t)b * T;
  int lo = INT_MAX, hi = INT_MIN, n = 0;
#pragma unroll
  for (int e = 0; e < WBN; e += 32) {
    const int t = j * WBN + e + lane;
    const int kp = t < T ? __ldg(row + t) : -1;
    if (kp >= 0) {
      lo = min(lo, kp);
      hi = max(hi, kp);
      ++n;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) summ[(size_t)b * nT + j] = make_int4(lo, hi, n, 0);
}

// Whether a tile with summary t may hold a key valid for some query at
// positions [lo, hi] (live), and whether its every one of WBN keys is
// valid for every such query (full); the masks are paged_attention.cuh's.
// Live errs towards true (min and max stand for the keys), full is exact.
__device__ __forceinline__ void summary_marks(const int4& t, int lo, int hi, int causal, int window,
                                              bool& live, bool& full) {
  live = t.z > 0 && (!causal || t.x <= hi) && (window <= 0 || t.y > lo - window);
  full = t.z == WBN && (!causal || t.y <= lo) && (window <= 0 || t.x > hi - window);
}

struct WgParams {
  CUtensorMap qmap;  // q [B, S, H, dh]: boxes of 64 columns x BM rows
  CUtensorMap kmap;  // k [B, T, Hkv, dh]: boxes of 64 columns x BN keys
  CUtensorMap vmap;
  CUtensorMap pmap;  // k_pos as [B * T] int32: boxes of BN positions
  const int* qpos;
  const int* kpos;   // [B, T]: the positions' tensor map
  const int4* summ;  // [B, nS] tile summaries (tile_summary_kernel); null: a row of one tile
  bf16* out;
  int B, S, T, H, Hkv, G, nS;
  paged::Mask mk;
  int capped;  // scores go through mk.score first (softcap, or a scale <= 0)
  float c;     // to the log2 domain: log2(e) * scale on raw products, log2(e) on capped scores
  float* lse;  // [B, H, S] row log-sum-exp (training: kernel 6b's input), or null
};

// NWG = 2: 128 query rows, tiles of 128 keys, one block per SM.  NWG = 1
// (a prefill of at most 64 tokens): 64 rows, tiles of 64 keys, half the
// shared memory, two blocks per SM.  Head dim 256 takes NWG = 2 only, over
// tiles of 64 keys: 128-key tiles would need 320 KB.
template <int DH, int NWG>
struct WgCfg {
  static_assert(DH != 256 || NWG == 2, "head dim 256: 128-row blocks only");
  static constexpr int BM = 64 * NWG;                     // query rows per block
  static constexpr int BN = DH == 256 ? 64 : 64 * NWG;    // keys per K/V tile
  static constexpr int NC = DH / 64;                      // 128-byte column boxes per row
  static constexpr int ST = NWG == 2 && DH == 64 ? 4 : 2;  // K/V stages in flight
  static constexpr int NT = 128 * (NWG + 1);              // consumer warpgroups + the producer's
  static constexpr int MIN_BLOCKS = NWG == 2 ? 1 : 2;     // per SM
  // registers a thread: the launch bound's share, then moved from the
  // producer to the consumers (24 + 2 x 240 of 3 x 168; 24 + 232 of 2 x 128)
  static constexpr int ENTRY_REGS = 65536 / MIN_BLOCKS / NT / 8 * 8;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = ((NWG + 1) * ENTRY_REGS - PRODUCER_REGS) / NWG / 8 * 8;
  static constexpr int WORDS = MAX_TILE_WORDS * BK / BN;  // live-tile bitmask: the same MAX_KEYS
};

// Tiles as TMA stores them with the 128-byte swizzle: [box][rows][64], each
// box 1024-byte aligned (the block aligns the base).
template <int DH, int NWG>
struct WgSmem {
  using C = WgCfg<DH, NWG>;
  bf16 q[C::NC][C::BM][64];
  bf16 k[C::ST][C::NC][C::BN][64];
  bf16 v[C::ST][C::NC][C::BN][64];
  alignas(128) int kp[C::ST][C::BN];  // the tile's key positions (the next row's past T)
  uint64_t kfull[C::ST];   // a stage's K and positions have landed (TMA bytes)
  uint64_t vfull[C::ST];   // its V has landed
  uint64_t kempty[C::ST];  // every consumer warp is done with its K and positions
  uint64_t vempty[C::ST];  // ... and with its V
  uint64_t qbar;           // the query tile has landed
  int qp[C::BM];
  unsigned live[C::WORDS];  // tiles that may hold a key valid for some row
  unsigned all[C::WORDS];   // tiles whose every key is valid for every row
  int qp_lo, qp_hi;
};

// The online softmax of one tile's scores sc (this thread's 2 rows x NS / 2
// columns, from the S accumulators), in the log2 domain: scale (and cap),
// mask (-inf: probability exactly 0; the running max stays finite), update
// the running max m and normaliser l, leave the probabilities in sc and the
// rescale factor of the earlier sums in alpha.  kp: the tile's key
// positions, t0 its first key.
template <int NS>
__device__ __forceinline__ void tile_softmax(float (&sc)[NS], const WgParams& p, const int* kp,
                                             int t0, bool all, const int (&qpr)[2], int cq,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  if (p.capped) {
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = p.mk.score(sc[i]);
  }
  if (!all) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = (i >> 2) * 8 + cq + (i & 1);
      if (t0 + col >= p.T || !p.mk.valid(kp[col], qpr[(i >> 1) & 1])) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * p.c);  // m starts at -1e30: stays finite
    alpha[r] = hopper::ex2(m[r] - m_new);          // 1 while no valid key was seen
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float pe = hopper::ex2(fmaf(sc[i], p.c, -m[(i >> 1) & 1]));  // 2^-inf = 0
    sc[i] = pe;
    l[(i >> 1) & 1] += pe;
  }
}

// O += P V for 16 keys: v is the stage's first column box at the k-step's
// first key (V's rows are keys, the K of the product; its 64-column boxes
// BN * 128 bytes apart along dh, the N; 8-key groups 1024 bytes apart).
template <int DH, int BN>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4], const bf16* v) {
  const uint64_t db = hopper::desc_sw128(v, BN * 128, 1024);
  if constexpr (DH == 256)
    hopper::wgmma_rs_n256_tb(o, a, db);
  else if constexpr (DH == 128)
    hopper::wgmma_rs_n128_tb(o, a, db);
  else
    hopper::wgmma_rs_n64_tb(o, a, db);
}

template <int BN>
__device__ __forceinline__ void wgmma_s(float (&sc)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 128)
    hopper::wgmma_ss_n128(sc, da, db, scale_d);
  else
    hopper::wgmma_ss_n64(sc, da, db, scale_d);
}

// The kernel's mbarrier waits.  At dh 256 each is one block of PTX
// (hopper::mbar_wait_ptx): with the C++ polling loop ptxas serialised every
// wgmma of the kernel and spilled.  Head dims 64 and 128 keep the loop they
// were measured with.
template <int DH>
__device__ __forceinline__ void stage_wait(uint64_t* bar, unsigned parity) {
  if constexpr (DH == 256)
    hopper::mbar_wait_ptx(bar, parity);
  else
    hopper::mbar_wait(bar, parity);
}

// LSE as for flash_bf16_kernel
template <int DH, int NWG, bool LSE>
__global__ void __launch_bounds__(WgCfg<DH, NWG>::NT, WgCfg<DH, NWG>::MIN_BLOCKS)
    flash_wgmma_kernel(const __grid_constant__ WgParams p) {
  using namespace hopper;
  using C = WgCfg<DH, NWG>;
  using Sm = WgSmem<DH, NWG>;
  constexpr int BM = C::BM, BN = C::BN, NC = C::NC, ST = C::ST;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  Sm& s = *reinterpret_cast<Sm*>(wg_smem + ((1024u - (smem_u32(wg_smem) & 1023u)) & 1023u));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.z, hk = h / p.G;
  const int s0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int nT = (p.T + BN - 1) / BN;  // K/V tiles

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&s.kfull[i], 1);
      mbar_init(&s.vfull[i], 1);
      mbar_init(&s.kempty[i], 4 * NWG);
      mbar_init(&s.vempty[i], 4 * NWG);
    }
    mbar_init(&s.qbar, 1);
    mbar_fence_init();
    s.qp_lo = INT_MAX;
    s.qp_hi = INT_MIN;
  }
  for (int i = tid; i < BM; i += C::NT)
    s.qp[i] = s0 + i < p.S ? __ldg(p.qpos + (size_t)b * p.S + s0 + i) : 0;
  __syncthreads();
  if (tid == NWG * 128) {  // the producer's thread: the query tile lands while the block marks
    mbar_expect_tx(&s.qbar, NC * BM * 128);
    for (int c = 0; c < NC; ++c) tma_load_4d(&s.q[c][0][0], &p.qmap, &s.qbar, c * 64, h, s0, b);
  }
  for (int i = tid; i < BM && s0 + i < p.S; i += C::NT) {
    atomicMin(&s.qp_lo, s.qp[i]);
    atomicMax(&s.qp_hi, s.qp[i]);
  }
  __syncthreads();
  if (p.summ == nullptr) {  // a row of one tile: live, and masked per entry
    if (tid == 0) {
      s.live[0] = 1u;
      s.all[0] = 0u;
    }
    __syncthreads();
  } else {  // the row's tile summaries (a 64-key tile takes its 128-key
            // summary: live and full stay exact or err towards live and not
            // full, which the per-entry mask covers)
    const int4* summ = p.summ + (size_t)b * p.nS;
    for (int base = 0; base < nT; base += C::NT) {
      const int j = base + tid;
      bool live = false, all = false;
      if (j < nT) summary_marks(__ldg(summ + j * BN / WBN), s.qp_lo, s.qp_hi, p.mk.causal,
                                p.mk.window, live, all);
      const unsigned lb = __ballot_sync(0xffffffffu, live), ab = __ballot_sync(0xffffffffu, all);
      if (lane == 0 && base + warp * 32 < nT) {
        s.live[(base >> 5) + warp] = lb;
        s.all[(base >> 5) + warp] = ab;
      }
    }
    __syncthreads();
  }

  const int wg = tid >> 7;
  if (wg == NWG) {
    // producer: one thread issues every load; the warpgroup gives up its registers
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (tid == NWG * 128) {
      int st = 0;
      unsigned ph = 0;
      for (int j = next_live(s.live, 0, nT); j < nT; j = next_live(s.live, j + 1, nT)) {
        // K (and positions) and V of a stage are released apart: K once the
        // tile's softmax is done, V once its P V is, so K runs further ahead
        stage_wait<DH>(&s.kempty[st], ph ^ 1u);  // a fresh stage passes at once
        mbar_expect_tx(&s.kfull[st], NC * BN * 128 + BN * 4);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(&s.k[st][c][0][0], &p.kmap, &s.kfull[st], c * 64, hk, j * BN, b);
        tma_load_1d(&s.kp[st][0], &p.pmap, &s.kfull[st], b * p.T + j * BN);
        stage_wait<DH>(&s.vempty[st], ph ^ 1u);
        mbar_expect_tx(&s.vfull[st], NC * BN * 128);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(&s.v[st][c][0][0], &p.vmap, &s.vfull[st], c * 64, hk, j * BN, b);
        if (++st == ST) {
          st = 0;
          ph ^= 1u;
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows 64 wg .. 64 wg + 63 of the block.
    // Tile j's S product is issued before tile j - 1's P V, and its softmax
    // runs while P V is on the tensor cores.  At dh 256 that overlap holds
    // O, S and P at once (176 registers before any other): there each
    // warpgroup runs a tile's S, softmax and P V in turn (SERIAL), and the
    // two warpgroups overlap each other (measured faster, PERF.md).
    constexpr bool SERIAL = DH == 256;
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int rl = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // this thread's rows: rl, rl + 8
    const int qpr[2] = {s.qp[rl], s.qp[rl + 8]};
    const int cq = (lane & 3) * 2;  // this thread's first column of each 8-column group
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {paged::NEG_INF, paged::NEG_INF};  // running max, log2 domain
    float l[2] = {0.f, 0.f};  // partial sums over this thread's columns
    uint32_t pa[BN / 16][4];  // P of the pending tile, bf16, as A fragments of P V
    float sc[BN / 2];
    int st = 0, pst = -1;  // this tile's stage; the pending P V's (-1: none)
    unsigned ph = 0, pph = 0;
    // O += P V of the pending tile
    auto issue_pv = [&]() {
      stage_wait<DH>(&s.vfull[pst], pph);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_pv<DH, BN>(o, pa[kk], &s.v[pst][0][16 * kk][0]);
      wg_commit();
    };
    auto retire_pv = [&]() {
      wg_wait<0>();
      fence_acc(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&s.vempty[pst]);  // this warp's reads of that V are done
    };
    stage_wait<DH>(&s.qbar, 0);
    for (int j = next_live(s.live, 0, nT); j < nT; j = next_live(s.live, j + 1, nT)) {
      const bool all = (s.all[j >> 5] >> (j & 31)) & 1u;
      stage_wait<DH>(&s.kfull[st], ph);
      // S = Q K^T: 64 rows x BN keys, k-steps of 16 along dh (32 bytes
      // inside a 128-byte swizzled row, then the next box)
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk >> 2, e0 = (kk & 3) * 16;
        wgmma_s<BN>(sc, desc_sw128(&s.q[c][64 * wg][e0], 16, 1024),
                    desc_sw128(&s.k[st][c][0][e0], 16, 1024), kk);
      }
      wg_commit();
      if (!SERIAL && pst >= 0) {
        issue_pv();
        wg_wait<1>();  // S is done; P V may still run
      } else {
        wg_wait<0>();
      }
      fence_acc(sc);
      float alpha[2];
      tile_softmax(sc, p, s.kp[st], j * BN, all, qpr, cq, m, l, alpha);
      if (lane == 0) mbar_arrive(&s.kempty[st]);  // this warp is done with K and positions
      if (!SERIAL && pst >= 0) retire_pv();
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // P rounded to bf16 (as _sdpa casts it to v's type), keys 16 kk .. 16 kk + 15
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      pst = st;
      pph = ph;
      if constexpr (SERIAL) {
        wg_fence();
        issue_pv();
        retire_pv();
        pst = -1;
      }
      if (++st == ST) {
        st = 0;
        ph ^= 1u;
      }
    }
    if (!SERIAL && pst >= 0) {  // the last tile's P V
      wg_fence();
      issue_pv();
      retire_pv();
    }

    // normalise (a row with no valid key has l = 0 and o = 0: writes 0) and store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int sq = s0 + rl + 8 * r;
      if (sq >= p.S) continue;
      if (LSE && (lane & 3) == 0)  // m in the log2 domain
        p.lse[((size_t)b * p.H + h) * p.S + sq] =
            l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f : INFINITY;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      bf16* row = p.out + (((size_t)b * p.S + sq) * p.H + h) * DH + cq;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8) =
            pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

using hopper::EncodeTiled;
using hopper::encoder;

// A bf16 tensor [d3, d2, d1, d0] (d0 innermost) as a 4-D map with boxes of
// 64 columns x 1 x rows x 1 and the 128-byte swizzle; out-of-bounds reads
// give 0.  The wrapper's tensor_map_args computes the same arguments.
bool encode_map(CUtensorMap* map, const void* base, int d0, int d1, int d2, int d3, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2, (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2,
                                 (cuuint64_t)d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// int32 positions [n] as a 1-D map with boxes of `box` (zero past n).
bool encode_positions(CUtensorMap* map, const int* base, size_t n, int box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // unused at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, const_cast<int*>(base), dims, strides, boxes, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, int NWG, bool LSE>
int launch_wgmma(WgParams& p, const void* q, const void* k, const void* v, cudaStream_t stream) {
  using C = WgCfg<DH, NWG>;
  const int smem = (int)sizeof(WgSmem<DH, NWG>) + 1024;  // + the 1024-byte alignment
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH, NWG, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  if (!encode_map(&p.qmap, q, DH, p.H, p.S, p.B, C::BM) ||
      !encode_map(&p.kmap, k, DH, p.Hkv, p.T, p.B, C::BN) ||
      !encode_map(&p.vmap, v, DH, p.Hkv, p.T, p.B, C::BN) ||
      !encode_positions(&p.pmap, p.kpos, (size_t)p.B * p.T, C::BN))
    return cudaErrorInvalidValue;
  if (p.summ != nullptr) {
    tile_summary_kernel<<<dim3((p.nS + 7) / 8, p.B), 256, 0, stream>>>(
        p.kpos, const_cast<int4*>(p.summ), p.T, p.nS);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_wgmma_kernel<DH, NWG, LSE>
      <<<dim3(p.H, (p.S + C::BM - 1) / C::BM, p.B), C::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
int dispatch_wgmma(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
                   void* out, void* summ, float* lse, int B, int S, int T, int H, int Hkv,
                   int q_tile, const paged::Mask& mk, cudaStream_t stream) {
  if ((q_tile != 64 && q_tile != 128) || (DH == 256 && q_tile != 128) || S > 65535 * 64 ||
      (summ == nullptr && T > 64))
    return cudaErrorInvalidValue;
  WgParams p{};
  p.qpos = qpos;
  p.kpos = kpos;
  p.summ = static_cast<const int4*>(summ);
  p.out = static_cast<bf16*>(out);
  p.lse = lse;
  p.B = B, p.S = S, p.T = T, p.H = H, p.Hkv = Hkv, p.G = H / Hkv, p.nS = (T + WBN - 1) / WBN;
  p.mk = mk;
  p.capped = mk.softcap > 0.f || mk.scale <= 0.f;
  p.c = p.capped ? 1.4426950408889634f : 1.4426950408889634f * mk.scale;
  if constexpr (DH == 256) {
    return lse != nullptr ? launch_wgmma<DH, 2, true>(p, q, k, v, stream)
                          : launch_wgmma<DH, 2, false>(p, q, k, v, stream);
  } else {
    if (lse != nullptr)
      return q_tile == 64 ? launch_wgmma<DH, 1, true>(p, q, k, v, stream)
                          : launch_wgmma<DH, 2, true>(p, q, k, v, stream);
    return q_tile == 64 ? launch_wgmma<DH, 1, false>(p, q, k, v, stream)
                        : launch_wgmma<DH, 2, false>(p, q, k, v, stream);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, the shared code of paged_attention.cuh
// ---------------------------------------------------------------------------

template <int DH, int NTF>
__global__ void __launch_bounds__(NTF) flash_f32_kernel(const Params p) {
  using A = paged::Attn<float, DH, RT, NTF>;
  extern __shared__ __align__(16) unsigned char smem[];
  A a(*reinterpret_cast<typename A::Smem*>(smem), p.mk);
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * RT;  // rows of batch row b: token * G + g
  const size_t qoff = (size_t)b * p.S * p.H * DH;
  a.load_queries(static_cast<const float*>(p.q) + qoff, p.qpos + (size_t)b * p.S, p.Hkv, h, p.G, row0,
                 min(RT, p.S * p.G - row0));
  const paged::KVfp<float> kv{static_cast<const float*>(p.k), static_cast<const float*>(p.v)};
  a.attend_contiguous(kv, p.kpos + (size_t)b * p.T, p.T, (size_t)b * p.T, p.Hkv, h);
  a.store(static_cast<float*>(p.out) + qoff, p.Hkv, h, p.G, row0);
  if (p.lse != nullptr) {  // m and l are final: the last tile's update ended on a barrier
    for (int r = threadIdx.x; r < a.nrows; r += NTF) {
      const int rg = row0 + r, c = rg / p.G, g = rg - c * p.G;
      const float l = a.s.l[r];
      p.lse[((size_t)b * p.H + h * p.G + g) * p.S + c] = l > 0.f ? a.s.m[r] + logf(l) : INFINITY;
    }
  }
}

template <int DH>
int launch_f32(const Params& p, cudaStream_t stream) {
  // a multiple of both 32 and DH (112 -> 224, 256 -> 256)
  constexpr int NTF = DH % 32 == 0 ? (DH > 128 ? DH : 128) : 2 * DH;
  const int smem = (int)sizeof(typename paged::Attn<float, DH, RT, NTF>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<DH, NTF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  flash_f32_kernel<DH, NTF><<<dim3((p.S * p.G + RT - 1) / RT, p.Hkv, p.B), NTF, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF16>
int dispatch(const void* q, const void* k, const void* v, const void* qpos, const void* kpos,
             void* out, void* summ, void* lse, int B, int S, int T, int H, int Hkv, int dh,
             int q_tile, float scale, int causal, int window, float softcap, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || (T + BK - 1) / BK > MAX_TILE_WORDS * 32)
    return cudaErrorInvalidValue;
  const paged::Mask mk{scale, softcap, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float* ls = static_cast<float*>(lse);
  if (BF16 && dh == 64)
    return dispatch_wgmma<64>(q, k, v, qp, kp, out, summ, ls, B, S, T, H, Hkv, q_tile, mk, st);
  if (BF16 && dh == 128)
    return dispatch_wgmma<128>(q, k, v, qp, kp, out, summ, ls, B, S, T, H, Hkv, q_tile, mk, st);
  if (BF16 && dh == 256)
    return dispatch_wgmma<256>(q, k, v, qp, kp, out, summ, ls, B, S, T, H, Hkv, q_tile, mk, st);
  const Params p{q, k, v, qp, kp, out, B, S, T, H, Hkv, H / Hkv, mk, ls};
  switch (dh) {
    case 32: return BF16 ? launch_bf16<32>(p, st) : launch_f32<32>(p, st);
    case 64: return launch_f32<64>(p, st);
    case 112: return BF16 ? launch_bf16<112>(p, st) : launch_f32<112>(p, st);
    case 128: return launch_f32<128>(p, st);
    case 256: return launch_f32<256>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, out (and, for the
// bf16 entry at head dims 64, 128 and 256, summ: B * ceil(T / 128) int4 tile
// summaries that a first launch writes and the blocks mark from, or null
// for rows of at most 64 keys; and lse: [B, H, S] f32 row log-sum-exp for
// the backward, kernel 6b, or null on every serving path)
// allocated by the caller, q_tile the bf16 wgmma path's
// query rows per block (64 or 128), stream a cudaStream_t; returns
// cudaGetLastError() (0 = success), or cudaErrorInvalidValue for arguments
// the kernels do not take (a tensor map that cannot be encoded among them).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, const void* qpos,
                                    const void* kpos, void* out, void* summ, void* lse, int B,
                                    int S, int T, int H, int Hkv, int dh, int q_tile, float scale,
                                    int causal, int window, float softcap, void* stream) {
  return dispatch<true>(q, k, v, qpos, kpos, out, summ, lse, B, S, T, H, Hkv, dh, q_tile, scale,
                        causal, window, softcap, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, const void* qpos,
                                   const void* kpos, void* out, void* lse, int B, int S, int T,
                                   int H, int Hkv, int dh, float scale, int causal, int window,
                                   float softcap, void* stream) {
  return dispatch<false>(q, k, v, qpos, kpos, out, nullptr, lse, B, S, T, H, Hkv, dh, 128, scale,
                         causal, window, softcap, stream);
}
