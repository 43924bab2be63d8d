// Tensor-core attention over a page pool or a contiguous cache for Hopper,
// sm_90a: the bf16 paths of paged_decode_attention.cu (kernels 7 and 7q),
// paged_prefill_attention.cu (kernels 8 and 8q) and decode_attention_quant.cu
// (kernel 9, a contiguous int8 cache, at head dims up to 128; dh 256 has a
// kernel of its own there).  Their f32 paths keep the CUDA-core code of
// paged_attention.cuh, whose Mask (scale, softcap, causal, window) all use.
//
// A block of 4 warps attends, for one kv-head, over the live keys of one
// row and then (prefill) over the chunk's own keys:
//
//   * live pages: the block compacts the row's live table entries (not the
//     trash page Pt - 1, not negative) into shared memory once, MAXL table
//     entries at a time (one window at the served table width of 128).  Key
//     i of a window is then offset i % ps of page i / ps, and a tile is 64
//     such keys: no serial page walk between tiles.  Trash entries are never
//     read.  A contiguous row (Src::table null, kernel 9) has no table: key i
//     of the row is cache row i, read as implicit pages of 64 keys, MAXL of
//     them (256 tiles, 16384 keys) a window, with no compaction.
//   * split-K (decode): the S blocks of a row share each window's live tiles
//     by rank (walk's sp, S) and write f32 partials that merge_splits, a
//     second launch, merges (decode_block).  A prefill block walks all its
//     tiles (S = 1).
//   * live and full tiles (prefill, and kernel 9's decode): before loading
//     any K/V the block marks the tiles that hold a key valid for some row
//     (the others are never loaded) and those whose every key is valid for
//     every row (no per-entry mask there), from the positions of the
//     window's keys, read once.  A kernel 9 block reads its row's positions
//     in bulk (mma_sm90.cuh's mark_tiles: each warp has 1024 of them in
//     flight before it reduces any), so every split's scan of a 16384-key
//     window costs four round trips to L2.  Liveness comes from the
//     positions only, so a ring cache whose live slots wrap, or a row that
//     is mostly empty, reads only the tiles that hold a valid key.  Kernel
//     7's decode takes every tile of its compacted row as live and masks
//     per entry.
//   * loads in flight: K/V tiles, their positions and scales are double-
//     buffered with cp.async (zero-filled past the last key, positions -1),
//     so the next tile loads while the block computes on this one and no
//     thread waits on a global read inside the walk.  An int8 cache (Q8)
//     lands as int8 and is widened to bf16 in shared memory (exact: |value|
//     <= 127, by an exponent trick, not an int-to-float conversion); its f32
//     scales per (key, kv-head) are applied to the products, K's to the score
//     column and V's to the probability before it is rounded for P.V.  That
//     computes (q . k) * s_k and sum p * s_v * v in f32, as the TPU kernel's
//     f32 dequantization does, without a bf16 rounding of value * scale.
//   * tensor cores: mma.sync m16n8k16, bf16 in and f32 accumulate, with the
//     query rows as A fragments in registers (ldmatrix, once), K read by
//     ldmatrix and V by ldmatrix.trans; the online softmax (running max m and
//     normaliser l per row) runs on the S accumulators in registers, and P is
//     rounded to bf16 as the A fragment of P.V, as kernel 6 and _sdpa round
//     it.  Masked entries get probability 0, so a row with no valid key ends
//     with l = 0 and acc = 0.
//
// The helpers (cp.async, ldmatrix, mma, the tile bitmask) are mma_sm90.cuh's,
// shared with kernel 6.
#pragma once

#include "mma_sm90.cuh"
#include "paged_attention.cuh"

namespace paged_mma {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr float NEG_INF = paged::NEG_INF;
constexpr int BK = 64;      // keys per tile
constexpr int NW = 4;       // warps per block
constexpr int NT = NW * 32;
constexpr int MAXL = 256;   // table entries compacted per window
constexpr int MAXT = 512;   // key tiles per window
constexpr int WORDS = MAXT / 32;
static_assert(MAXL % NT == 0, "the compaction takes NT entries a round");
static_assert(MAXL * paged::KT / BK <= MAXT / 2, "a window's pool tiles leave room for chunk tiles");

// What a block attends over: the live pages of one block-table row, then the
// C keys of a chunk (C = 0: none); or, with table null, the T keys of one
// contiguous cache row (k, v, ks, vs and kpos point at the row's first key,
// ps = BK).
struct Src {
  const void* k;        // pool [Pt, ps, Hkv, DH]: bf16, or int8 (Q8)
  const void* v;
  const float* ks;      // Q8: scales [Pt, ps, Hkv]
  const float* vs;
  const int* kpos;      // [Pt, ps]
  const int* table;     // the row; null: a contiguous row
  const bf16* ck;       // the chunk's keys and values [C, Hkv, DH]
  const bf16* cv;
  const int* cpos;      // their positions [C]
  int ps, Pt, Hkv, h, C;
  int mask_from;        // pool keys at positions >= this are masked
  int T;                // contiguous: keys in the row
};

// NB compute buffers: 2 (double-buffered), or 1 where only int8 pool tiles
// arrive (they are double-buffered in k8 / v8 and widened into the one).
template <int DH, bool Q8, int NB>
struct Smem {
  static constexpr int LD = DH + 8;  // padded row: ldmatrix rows on distinct banks
  alignas(16) bf16 k[NB][BK][LD];    // the query rows are staged in k[NB - 1] first
  alignas(16) bf16 v[NB][BK][LD];
  alignas(16) int8_t k8[Q8 ? 2 : 1][Q8 ? BK : 1][Q8 ? DH : 16];
  alignas(16) int8_t v8[Q8 ? 2 : 1][Q8 ? BK : 1][Q8 ? DH : 16];
  float ks[Q8 ? 2 : 1][Q8 ? BK : 1];  // per-key scales of a tile (1 for chunk keys)
  float vs[Q8 ? 2 : 1][Q8 ? BK : 1];
  int kp[2][BK];                      // key positions of a tile, -1 = masked
  int page[MAXL];                     // the window's live pages
  unsigned live[WORDS];               // tiles with a key valid for some row
  unsigned full[WORDS];               // tiles whose every key is valid for every row
  int qp[BK];                         // query positions of the block's rows
  float wm[NW][16], wl[NW][16];       // decode: each warp's m and l per row
  int wcount[NW];
  int n_live, qp_lo, qp_hi;
};

// The tile walk shared by both kernels.
template <int DH, bool Q8, int NB>
struct Tiles {
  using Sm = Smem<DH, Q8, NB>;
  static constexpr int CH = DH / 8;    // 16-byte chunks of a bf16 row
  static constexpr int CH8 = DH / 16;  // of an int8 row
  static_assert(DH % 16 == 0, "k-steps of 16");

  Sm& s;
  const Src& src;
  const paged::Mask mk;
  const bool scan;  // mark tiles from their keys' positions; else every tile is live, none full
  const int tid, lane, warp;
  int n_pool = 0, nTp = 0, c0 = 0;  // the window: live pool keys, pool tiles, first chunk key
  int k0 = 0;                       // contiguous: the window's first key of the row

  __device__ Tiles(Sm& sm, const Src& sr, const paged::Mask& m, bool scan_tiles)
      : s(sm), src(sr), mk(m), scan(scan_tiles), tid(threadIdx.x), lane(threadIdx.x & 31),
        warp(threadIdx.x >> 5) {}

  // Pool row (page * ps + offset) of live key i of the window; contiguous:
  // key k0 + i of the row.
  __device__ __forceinline__ int pool_row(int i) const {
    if (src.table == nullptr) return k0 + i;
    const int n = i / src.ps;
    return s.page[n] * src.ps + (i - n * src.ps);
  }

  // Position of key e of tile t; -1 where no row may see it.
  __device__ __forceinline__ int key_pos(int t, int e) const {
    if (t < nTp) {
      const int i = t * BK + e;
      if (i >= n_pool) return -1;
      const int p = __ldg(src.kpos + pool_row(i));
      return p >= src.mask_from ? -1 : p;
    }
    const int c = c0 + (t - nTp) * BK + e;
    return c < src.C ? __ldg(src.cpos + c) : -1;
  }

  // The live entries of table entries [e0, e1) (e1 - e0 <= MAXL) into
  // s.page[0 .. s.n_live), in table order.
  __device__ void compact(int e0, int e1) {
    if (tid == 0) s.n_live = 0;
    __syncthreads();
    for (int base = e0; base < e1; base += NT) {
      const int e = base + tid;
      const int pg = e < e1 ? __ldg(src.table + e) : -1;
      const bool live = pg >= 0 && pg != src.Pt - 1;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (lane == 0) s.wcount[warp] = __popc(mask);
      __syncthreads();
      int off = s.n_live + __popc(mask & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) off += s.wcount[w];
      if (live) s.page[off] = pg;
      __syncthreads();
      if (tid == 0) {
        int n = s.n_live;
        for (int w = 0; w < NW; ++w) n += s.wcount[w];
        s.n_live = n;
      }
      __syncthreads();
    }
  }

  // Mark the live and the full tiles among the window's nT (s.qp_lo and
  // s.qp_hi bound the block's query positions).
  __device__ void mark(int nT) {
    if (scan && src.table == nullptr) {  // a contiguous row: the window's positions, in bulk
      __syncthreads();  // s.qp_lo / s.qp_hi are written
      mark_tiles<BK, 32>(src.kpos + k0, n_pool, s.qp_lo, s.qp_hi, mk.causal, mk.window, s.live, s.full,
                     WORDS);
      return;
    }
    for (int w = tid; w < WORDS; w += NT) {
      const int n = min(32, max(0, nT - w * 32));
      s.live[w] = scan ? 0u : (n == 32 ? ~0u : (1u << n) - 1u);
      s.full[w] = 0;
    }
    __syncthreads();
    if (!scan) return;
    const int lo = s.qp_lo, hi = s.qp_hi;
    for (int t = warp; t < nT; t += NW) {
      bool may = false, all = true;
#pragma unroll
      for (int e = 0; e < BK; e += 32) {
        const int kp = key_pos(t, e + lane);
        may |= kp >= 0 && (!mk.causal || kp <= hi) && (mk.window <= 0 || kp > lo - mk.window);
        all &= kp >= 0 && (!mk.causal || kp <= lo) && (mk.window <= 0 || kp > hi - mk.window);
      }
      const bool any_may = __any_sync(0xffffffffu, may), all_ok = __all_sync(0xffffffffu, all);
      if (lane == 0 && any_may) atomicOr(&s.live[t >> 5], 1u << (t & 31));
      if (lane == 0 && all_ok) atomicOr(&s.full[t >> 5], 1u << (t & 31));
    }
    __syncthreads();
  }

  // Start tile t's K/V into buffer b (cp.async, one commit group) and write
  // its positions (and scales) there.
  __device__ void load(int t, int b) {
    if (t < nTp) {
      const int i0 = t * BK;
      if constexpr (Q8) {
        const int8_t* K = static_cast<const int8_t*>(src.k);
        const int8_t* V = static_cast<const int8_t*>(src.v);
        for (int i = tid; i < BK * CH8; i += NT) {
          const int r = i / CH8, c = (i - r * CH8) * 16, key = i0 + r;
          const bool ok = key < n_pool;
          const size_t off = ok ? ((size_t)pool_row(key) * src.Hkv + src.h) * DH + c : 0;
          cp_async16(&s.k8[b][r][c], K + off, ok);
          cp_async16(&s.v8[b][r][c], V + off, ok);
        }
      } else {
        const bf16* K = static_cast<const bf16*>(src.k);
        const bf16* V = static_cast<const bf16*>(src.v);
        for (int i = tid; i < BK * CH; i += NT) {
          const int r = i / CH, c = (i - r * CH) * 8, key = i0 + r;
          const bool ok = key < n_pool;
          const size_t off = ok ? ((size_t)pool_row(key) * src.Hkv + src.h) * DH + c : 0;
          cp_async16(&s.k[b][r][c], K + off, ok);
          cp_async16(&s.v[b][r][c], V + off, ok);
        }
      }
      if (tid < BK) {  // positions (masked from mask_from on at use) and scales, in flight too
        const int key = i0 + tid;
        if (key < n_pool) {
          const int row = pool_row(key);
          cp_async4(&s.kp[b][tid], src.kpos + row);
          if constexpr (Q8) {
            cp_async4(&s.ks[b][tid], src.ks + (size_t)row * src.Hkv + src.h);
            cp_async4(&s.vs[b][tid], src.vs + (size_t)row * src.Hkv + src.h);
          }
        } else {
          s.kp[b][tid] = -1;
          if constexpr (Q8) s.ks[b][tid] = s.vs[b][tid] = 0.f;
        }
      }
    } else if constexpr (NB == 2) {  // the chunk's own keys, bf16 also beside an int8 pool
      const int k0 = c0 + (t - nTp) * BK;
      for (int i = tid; i < BK * CH; i += NT) {
        const int r = i / CH, c = (i - r * CH) * 8, key = k0 + r;
        const bool ok = key < src.C;
        const size_t off = ok ? ((size_t)key * src.Hkv + src.h) * DH + c : 0;
        cp_async16(&s.k[b][r][c], src.ck + off, ok);
        cp_async16(&s.v[b][r][c], src.cv + off, ok);
      }
      if (tid < BK) {
        const int key = k0 + tid;
        if (key < src.C)
          cp_async4(&s.kp[b][tid], src.cpos + key);
        else
          s.kp[b][tid] = -1;
        if constexpr (Q8) s.ks[b][tid] = s.vs[b][tid] = 1.f;
      }
    }
    cp_async_commit();
  }

  // Q8: the int8 tile in k8 / v8[b] widened into compute buffer cb.
  __device__ void widen(int b, int cb) {
    if constexpr (Q8) {
      for (int i = tid; i < BK * CH8; i += NT) {
        const int r = i / CH8, c = (i - r * CH8) * 16;
        widen16(&s.k8[b][r][c], &s.k[cb][r][c]);
        widen16(&s.v8[b][r][c], &s.v[cb][r][c]);
      }
    }
  }

  static __device__ __forceinline__ void widen16(const int8_t* in, bf16* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(in);
    uint32_t w[8];
    int8x4_to_bf16(raw.x, w[0], w[1]);
    int8x4_to_bf16(raw.y, w[2], w[3]);
    int8x4_to_bf16(raw.z, w[4], w[5]);
    int8x4_to_bf16(raw.w, w[6], w[7]);
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(out + 8) = make_uint4(w[4], w[5], w[6], w[7]);
  }

  // Split sp of S: the live pages of the table row's nt entries (contiguous:
  // nt implicit pages of ps = BK keys), a window of MAXL entries at a time,
  // then the chunk's keys; of each window's live
  // tiles this split takes those of rank [sp * L / S, (sp + 1) * L / S).
  // ready() runs once, after the query rows (committed by the caller before
  // the walk) have landed and before any tile overwrites them;
  // tile(cb, b, full, lim) runs for each tile taken, with its K/V in compute
  // buffer cb, its positions and scales in slot b and the position lim from
  // which its keys are masked, every thread of the block together.
  template <class Ready, class Tile>
  __device__ void walk(int nt, int sp, int S, Ready&& ready, Tile&& tile) {
    bool first = true;
    int e0 = 0;
    c0 = 0;
    do {
      const int e1 = min(nt, e0 + MAXL);
      if (src.table != nullptr) {
        compact(e0, e1);
        n_pool = s.n_live * src.ps;
      } else {  // mark's first barrier orders this window after the last one's reads
        k0 = e0 * src.ps;
        n_pool = min(src.T - k0, (e1 - e0) * src.ps);
      }
      nTp = (n_pool + BK - 1) / BK;
      const int nTc = e1 == nt ? min((src.C - c0 + BK - 1) / BK, MAXT - nTp) : 0;
      const int nT = nTp + nTc;
      mark(nT);
      int L = 0;
      for (int w = 0; w < WORDS; ++w) L += __popc(s.live[w]);
      const int lo = sp * L / S, hi = (sp + 1) * L / S;  // L <= MAXT: no overflow
      int j = next_live(s.live, 0, nT);
      for (int r = 0; r < lo; ++r) j = next_live(s.live, j + 1, nT);
      int left = hi - lo;
      if (left > 0) load(j, 0);
      cp_async_wait_all();  // also the query rows, in the first window
      __syncthreads();
      if (first) {
        ready();
        __syncthreads();  // every warp holds its query fragments
        first = false;
      }
      int b = 0;
      while (left-- > 0) {
        const int jn = left > 0 ? next_live(s.live, j + 1, nT) : nT;
        if (jn < nT) load(jn, b ^ 1);  // released by the barrier that ended the last tile
        const int cb = NB == 2 ? b : 0;
        if (Q8 && j < nTp) {
          widen(b, cb);
          __syncthreads();
        }
        tile(cb, b, (s.full[j >> 5] >> (j & 31)) & 1u, j < nTp ? src.mask_from : INT_MAX);
        cp_async_wait_all();  // the next tile has landed ...
        __syncthreads();      // ... for every thread, and this one is consumed
        b ^= 1;
        j = jn;
      }
      e0 = e1;
      c0 += nTc * BK;
    } while (e0 < nt || c0 < src.C);
  }
};

// One warp's online-softmax update of its 16 rows with N * 8 keys of a tile
// (keys key0 .. key0 + 8 N - 1 of slot b / buffer cb), from the S
// accumulators sc, then O += P V.  qpr: the positions of this thread's two
// rows (lane / 4 and lane / 4 + 8); keys at positions >= lim are masked; l
// holds this thread's partial sums.
template <int DH, bool Q8, int N, class Sm>
__device__ __forceinline__ void update(const Sm& s, int cb, int b, int key0, bool full, int lim,
                                       const paged::Mask& mk, const int qpr[2], float (&sc)[N][4],
                                       float (&m)[2], float (&l)[2], float (&o)[DH / 8][4],
                                       int lane) {
  static_assert(N * 4 <= 32 && N % 2 == 0, "one bit per S accumulator; k-steps of 16 keys");
  const int c0 = (lane & 3) * 2;  // this thread's first column in an 8-wide tile
  if constexpr (Q8) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= s.ks[b][key0 + n * 8 + c0 + (e & 1)];
  }
  float mx[2] = {NEG_INF, NEG_INF};
  uint32_t valid = ~0u;  // bit n * 4 + e: entry sc[n][e] is unmasked
  if (full) {
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = mk.score(sc[n][e]);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
  } else {
    valid = 0;
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = s.kp[b][key0 + n * 8 + c0 + (e & 1)];
        if (kp < lim && mk.valid(kp, qpr[e >> 1])) {
          valid |= 1u << (n * 4 + e);
          sc[n][e] = mk.score(sc[n][e]);
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
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
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = (valid >> (n * 4 + e)) & 1u ? __expf(sc[n][e] - m[e >> 1]) : 0.f;
      l[e >> 1] += pe;
      if constexpr (Q8) {
        sc[n][e] = pe == 0.f ? 0.f : pe * s.vs[b][key0 + n * 8 + c0 + (e & 1)];
      } else {
        sc[n][e] = pe;
      }
    }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  // O += P V: P's accumulators, rounded to bf16, are the A fragments
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                           pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                           pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, &s.v[cb][key0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8][dp * 16 + (lane >> 4) * 8]);
      mma_bf16(o[2 * dp], a, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], a, vb[2], vb[3]);
    }
  }
}

// S = Q K^T for one warp: its query fragments qf against N * 8 keys from
// key0 of compute buffer cb.
template <int DH, int N, class Sm>
__device__ __forceinline__ void scores(const Sm& s, int cb, int key0, uint32_t (&qf)[DH / 16][4],
                                       float (&sc)[N][4], int lane) {
#pragma unroll
  for (int n = 0; n < N; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < N / 2; ++np) {
      uint32_t kb[4];
      ldmatrix_x4(kb, &s.k[cb][key0 + np * 16 + (lane >> 4) * 8 + (lane & 7)][kk * 16 + ((lane >> 3) & 1) * 8]);
      mma_bf16(sc[2 * np], qf[kk], kb[0], kb[1]);
      mma_bf16(sc[2 * np + 1], qf[kk], kb[2], kb[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Split-K decode (kernels 7, 7q and 9): one block's share of one (slot,
// kv-head) row, then the merge launch
// ---------------------------------------------------------------------------

constexpr int GR = 16;  // query rows of a decode block: the G <= 16 heads, one fragment

// Split-K partials in a workspace, split-major over the R rows of the
// output (row = slot * Hkv * G + kv-head * G + grouped head): m [S][R],
// l [S][R], acc [S][R][DH], all f32.
__device__ __forceinline__ float* partial_m(float* ws, size_t R, int sp) { return ws + sp * R; }
__device__ __forceinline__ float* partial_l(float* ws, size_t R, int S, int sp) {
  return ws + (S + sp) * R;
}
template <int DH>
__device__ __forceinline__ float* partial_acc(float* ws, size_t R, int S, int sp) {
  return ws + 2 * S * R + sp * R * DH;
}

// out[row] = sum_s acc_s e^(m_s - m*) / sum_s l_s e^(m_s - m*), m* = max_s m_s:
// a split with no valid key (m = -1e30, l = 0, acc = 0) adds 0, a row with
// none in any split gives 0.  One thread per output value.
template <int DH>
__global__ void __launch_bounds__(256) merge_splits(const float* __restrict__ ws,
                                                    bf16* __restrict__ out, int R, int S) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)R * DH) return;
  const size_t row = i / DH, d = i - row * DH;
  const float* m = ws;
  const float* l = ws + (size_t)S * R;
  const float* acc = ws + 2 * (size_t)S * R;
  float mx = paged::NEG_INF;
  for (int sp = 0; sp < S; ++sp) mx = fmaxf(mx, m[sp * (size_t)R + row]);
  float a = 0.f, z = 0.f;
  for (int sp = 0; sp < S; ++sp) {
    const size_t r = sp * (size_t)R + row;
    const float e = __expf(m[r] - mx);
    a += acc[r * DH + d] * e;
    z += l[r] * e;
  }
  out[i] = __float2bfloat16(a / fmaxf(z, 1e-30f));
}

// Launch merge_splits over the R * DH outputs of a split-K decode.
template <int DH>
inline cudaError_t launch_merge(const float* ws, bf16* out, int R, int S, cudaStream_t stream) {
  const size_t n = (size_t)R * DH;
  merge_splits<DH><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(ws, out, R, S);
  return cudaGetLastError();
}

// Split sp of S of one decode row: the G query rows q (G * DH bf16, 16-byte
// aligned) at position qp attend over src's keys (a table row: nt entries;
// contiguous: nt = ceil(T / BK) implicit pages); scan marks live and full
// tiles from the keys' positions (else every tile is live and masked per
// entry).  Each of the 4 warps takes 16 keys of a tile with its own online
// softmax; at the end the warps merge in shared memory and the block writes
// its f32 partials for output rows row0 .. row0 + G - 1 of R, or at S = 1
// the output itself.  A split with no valid key writes m = -1e30, l = 0,
// acc = 0.
template <int DH, bool Q8, int NB>
__device__ __forceinline__ void decode_block(Smem<DH, Q8, NB>& s, const Src& src, const bf16* q,
                                             int G, int qp, const paged::Mask& mk, bool scan,
                                             int nt, int sp, int S, bf16* out, float* ws,
                                             size_t R, size_t row0) {
  constexpr int KS = DH / 16, CH = DH / 8;
  static_assert(DH <= 128, "a thread holds its query fragments beside DH / 2 f32 accumulators");
  static_assert(sizeof(Smem<DH, Q8, NB>::k) + sizeof(Smem<DH, Q8, NB>::v) >=
                    sizeof(float) * NW * GR * DH,
                "the warps' accumulators fit in the tile buffers");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the G query rows (zero past G) into k[NB - 1], rows of DH + 8
  bf16* qrows = &s.k[NB - 1][0][0];
  for (int i = tid; i < GR * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = r < G;
    cp_async16(qrows + r * (DH + 8) + c, q + (ok ? r * DH + c : 0), ok);
  }
  cp_async_commit();
  if (tid == 0) s.qp_lo = s.qp_hi = qp;  // read by mark, after its first barrier

  Tiles<DH, Q8, NB> tiles(s, src, mk, scan);
  const int qpr[2] = {qp, qp};
  const int key0 = warp * 16;  // this warp's keys of each tile
  uint32_t qf[KS][4];
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  tiles.walk(
      nt, sp, S,
      [&]() {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], &s.k[NB - 1][lane & 15][kk * 16 + (lane >> 4) * 8]);
      },
      [&](int cb, int bb, bool full, int lim) {
        float sc[2][4];
        scores<DH, 2>(s, cb, key0, qf, sc, lane);
        update<DH, Q8, 2>(s, cb, bb, key0, full, lim, mk, qpr, sc, m, l, o, lane);
      });

  // merge the 4 warps (the walk ended on a barrier: the tile buffers are free)
  float(*acc)[GR][DH] = reinterpret_cast<float(*)[GR][DH]>(&s.k[0][0][0]);
  const int r0 = lane >> 2, c0 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if ((lane & 3) == 0) {
      s.wm[warp][r0 + 8 * i] = m[i];
      s.wl[warp][r0 + 8 * i] = l[i];
    }
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      acc[warp][r0 + 8 * i][n * 8 + c0] = o[n][2 * i];
      acc[warp][r0 + 8 * i][n * 8 + c0 + 1] = o[n][2 * i + 1];
    }
  }
  __syncthreads();
  // one split: the output; several: this split's partials (merge_splits)
  for (int i = tid; i < G * DH; i += NT) {
    const int g = i / DH, d = i - g * DH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s.wm[w][g]);
    float a = 0.f, z = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float e = __expf(s.wm[w][g] - mx);
      a += acc[w][g][d] * e;
      z += s.wl[w][g] * e;
    }
    if (S == 1) {
      out[(row0 + g) * DH + d] = __float2bfloat16(a / fmaxf(z, 1e-30f));
      continue;
    }
    partial_acc<DH>(ws, R, S, sp)[(row0 + g) * DH + d] = a;
    if (d == 0) {
      partial_m(ws, R, sp)[row0 + g] = mx;
      partial_l(ws, R, S, sp)[row0 + g] = z;
    }
  }
}

}  // namespace paged_mma
