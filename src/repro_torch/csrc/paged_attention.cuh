// CUDA-core device code shared by the f32 paths of the attention kernels for
// Hopper, sm_90a: paged_decode_attention.cu (one query token per slot) and
// paged_prefill_attention.cu (one prefill chunk of one sequence), both over a
// page pool in f32 or int8, decode_attention_quant.cu (kernel 9: one query
// token per slot over a contiguous int8 cache) and flash_attention.cu.  The
// bf16 paths (kernels 6-9) run on the tensor cores (paged_mma.cuh, and
// kernel 6's own) and take only Mask (scale, softcap, causal, window) from
// here.
//
// All compute, for one kv-head and a set of query rows, a masked softmax
// attention over keys streamed in tiles of up to KT = 32 keys, as the TPU
// kernels do with their sequential page / key-tile grid axis:
//
//   * the query rows of the block (row = token * G + grouped head, so head
//     h_q = kv * G + g as the model's [H] -> [Hkv, G] reshape gives) are
//     staged once in shared memory as f32;
//   * a tile is staged in shared memory as f32 (K rows padded by one float so
//     the per-thread dot products read distinct banks), with its absolute
//     positions, which carry the masks: pos < 0 (empty or trash entry),
//     causal (pos > query position), window (query - pos >= window).  An
//     int8 cache (KVq8) is widened while it is staged: each value times the
//     f32 scale of its (key, kv-head), in f32, as the TPU kernels dequantize
//     in VMEM; everything after staging is the same code for both layouts;
//   * scores in f32 (scale, then softcap), an online softmax per row (running
//     max m, normaliser l; one warp per row, one lane per key) and the P.V
//     update of an f32 accumulator held in registers (thread = one head-dim
//     column, RT / (NT / DH) rows).
//
// Masked entries get probability 0 explicitly, as in the TPU kernels
// (attention_paged.py:80-83, attention_prefill_paged.py:100-103): while no
// valid key has been seen the running max is still NEG_INF and
// exp(NEG_INF - NEG_INF) = 1 would count every masked key into l.  A row with
// no valid key ends with acc = 0 and l = 0 and writes 0 / 1e-30 = 0, finite.
//
// Pool pages come through the block table, which the caller pre-clamps (-1 ->
// the trash page Pt - 1, whose positions stay -1).  Trash entries are skipped
// without reading anything: a 128-entry table of a short sequence would
// otherwise stream the trash page about 120 times.  One warp compacts the next
// live entries of the table into a tile (KT / page_size pages), and a tile
// whose keys are masked for every row of the block (empty pages, keys past the
// block's last causal query) is skipped after reading only its positions.
// Skipping is exact: a fully masked tile leaves m, l and acc unchanged.
//
// What holds this code back: every product is an FMA on the CUDA cores out of
// f32 shared memory, and each tile waits on a barrier between its load and
// its use, with no load in flight.  The f32 paths exist for the reduced
// card-vs-CPU checks.
//
// Exponentials use expf (not __expf) and there is no fast-math flag, so f32
// results differ from the plain PyTorch version only in summation order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace paged {

constexpr float NEG_INF = -1e30f;
constexpr int KT = 32;   // keys per tile: one lane per key in the softmax step
constexpr int VEC = 4;   // elements per vector load of a K/V row

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

__device__ __forceinline__ void load4(const float* p, float v[VEC]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// Where a tile's K/V come from: a cache in the input type, or an int8 cache
// with one f32 scale per (key, kv-head).  Rows are [rows, Hkv, DH].
template <typename T>
struct KVfp {
  const T* k;
  const T* v;
};

struct KVq8 {
  const int8_t* k;
  const float* ks;  // [rows, Hkv] (the [..., Hkv, 1] scales)
  const int8_t* v;
  const float* vs;
};

// The C entry points' untyped pointers as a K/V source.
template <typename T>
inline KVfp<T> kv_fp(const void* k, const void* v) {
  return {static_cast<const T*>(k), static_cast<const T*>(v)};
}

inline KVq8 kv_q8(const void* k, const void* ks, const void* v, const void* vs) {
  return {static_cast<const int8_t*>(k), static_cast<const float*>(ks),
          static_cast<const int8_t*>(v), static_cast<const float*>(vs)};
}

// Scale, softcap and masks: the kernels' static arguments on the TPU.
struct Mask {
  float scale;
  float softcap;  // <= 0: off
  int causal;
  int window;     // <= 0: off

  __device__ __forceinline__ bool valid(int kp, int qp) const {
    return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
  }
  __device__ __forceinline__ float score(float dot) const {
    float s = dot * scale;
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    return s;
  }
};

// One block: RT query rows of one kv-head, NT threads, head dim DH.
template <typename T, int DH, int RT, int NT>
struct Attn {
  static constexpr int NW = NT / 32;
  static constexpr int KS = DH + 1;          // padded K row
  static constexpr int RSTEP = NT / DH;      // rows between a thread's accumulators
  static constexpr int RPT = RT / RSTEP;     // accumulators per thread
  static_assert(KT == 32, "the softmax step maps one lane to one key");
  static_assert(NT % 32 == 0 && NT % DH == 0 && RT % RSTEP == 0, "block shape");
  static_assert(DH % VEC == 0, "vector loads");

  struct Smem {
    float q[RT][DH];
    float k[KT][KS];
    float v[KT][DH];
    float p[RT][KT];     // scores, then probabilities
    float m[RT];
    float l[RT];
    float alpha[RT];
    int qp[RT];          // query positions
    int kp[KT];          // key positions of the tile (-1 = masked)
    int page[KT];        // pool pages of the tile
    int next_entry;      // next table entry to look at
    int n_pages;         // pages in the tile
    int qp_lo, qp_hi;    // query position range of the block
  };

  Smem& s;
  const Mask mk;
  const int tid, lane, warp;
  int nrows = 0, qp_lo = 0, qp_hi = 0;
  float acc[RPT];

  __device__ Attn(Smem& sm, const Mask& m)
      : s(sm), mk(m), tid(threadIdx.x), lane(threadIdx.x & 31), warp(threadIdx.x >> 5) {}

  // Rows row0 .. row0 + n - 1 of q [tokens, Hkv, G, DH]; row = token * G + g.
  __device__ void load_queries(const T* q, const int* qpos, int Hkv, int h, int G, int row0, int n) {
    nrows = n;
    for (int i = tid; i < n * DH; i += NT) {
      const int r = i / DH, d = i - r * DH;
      const int rg = row0 + r, c = rg / G, g = rg - c * G;
      s.q[r][d] = to_f32(q[((size_t)(c * Hkv + h) * G + g) * DH + d]);
      if (d == 0) s.qp[r] = qpos[c];
    }
    for (int r = tid; r < RT; r += NT) {
      s.m[r] = NEG_INF;
      s.l[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    __syncthreads();
    if (tid == 0) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int r = 0; r < n; ++r) {
        lo = min(lo, s.qp[r]);
        hi = max(hi, s.qp[r]);
      }
      s.qp_lo = lo;
      s.qp_hi = hi;
    }
    __syncthreads();
    qp_lo = s.qp_lo;
    qp_hi = s.qp_hi;
  }

  // After s.kp[0..nk) is written: whether any key of the tile can be valid
  // for some row of the block (a necessary condition; also a barrier).
  __device__ bool tile_live(int nk) {
    const int kp = tid < nk ? s.kp[tid] : -1;
    const bool may = kp >= 0 && (!mk.causal || kp <= qp_hi) &&
                     (mk.window <= 0 || kp > qp_lo - mk.window);
    return __syncthreads_or(may) != 0;
  }

  // Stage K/V rows of the tile: key j lives at row row_of(j) of a
  // [rows, Hkv, DH] array (a pool page row is page * ps + offset).
  template <typename RowOf>
  __device__ void stage(const KVfp<T>& src, int Hkv, int h, int nk, RowOf row_of) {
    constexpr int NV = DH / VEC;
    for (int i = tid; i < nk * NV; i += NT) {
      const int j = i / NV, c = (i - j * NV) * VEC;
      const size_t off = ((size_t)row_of(j) * Hkv + h) * DH + c;
      float kv[VEC], vv[VEC];
      load4(src.k + off, kv);
      load4(src.v + off, vv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        s.k[j][c + e] = kv[e];
        s.v[j][c + e] = vv[e];
      }
    }
    __syncthreads();
  }

  // The same from an int8 cache: 4 values per load (one 32-bit word), each
  // times its (key, kv-head) scale in f32.
  template <typename RowOf>
  __device__ void stage(const KVq8& src, int Hkv, int h, int nk, RowOf row_of) {
    constexpr int NV = DH / VEC;
    for (int i = tid; i < nk * NV; i += NT) {
      const int j = i / NV, c = (i - j * NV) * VEC;
      const size_t row = (size_t)row_of(j) * Hkv + h;
      const float sk = __ldg(src.ks + row), sv = __ldg(src.vs + row);
      const char4 kq = __ldg(reinterpret_cast<const char4*>(src.k + row * DH + c));
      const char4 vq = __ldg(reinterpret_cast<const char4*>(src.v + row * DH + c));
      s.k[j][c + 0] = (float)kq.x * sk;
      s.k[j][c + 1] = (float)kq.y * sk;
      s.k[j][c + 2] = (float)kq.z * sk;
      s.k[j][c + 3] = (float)kq.w * sk;
      s.v[j][c + 0] = (float)vq.x * sv;
      s.v[j][c + 1] = (float)vq.y * sv;
      s.v[j][c + 2] = (float)vq.z * sv;
      s.v[j][c + 3] = (float)vq.w * sv;
    }
    __syncthreads();
  }

  // Online-softmax update of every row with the staged tile of nk keys.
  __device__ void process_tile(int nk) {
    for (int i = tid; i < nrows * nk; i += NT) {
      const int r = i / nk, j = i - r * nk;
      const float* qr = s.q[r];
      const float* kr = s.k[j];
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], kr[d], dot);
      s.p[r][j] = mk.score(dot);
    }
    __syncthreads();
    for (int r = warp; r < nrows; r += NW) {
      const bool ok = lane < nk && mk.valid(s.kp[lane], s.qp[r]);
      const float sc = ok ? s.p[r][lane] : NEG_INF;
      float mx = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s.m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float e = ok ? expf(sc - m_new) : 0.f;
      float sum = e;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s.p[r][lane] = e;
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        s.alpha[r] = a;
        s.l[r] = s.l[r] * a + sum;
        s.m[r] = m_new;
      }
    }
    __syncthreads();
    const int d = tid % DH, r0 = tid / DH;
    float vr[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) vr[j] = j < nk ? s.v[j][d] : 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i * RSTEP;
      if (r < nrows) {
        float a = acc[i] * s.alpha[r];
#pragma unroll
        for (int j = 0; j < KT; ++j) a = fmaf(s.p[r][j], vr[j], a);  // p = 0 past nk
        acc[i] = a;
      }
    }
  }

  // Warp 0: the next KT / ps live entries of the table row into s.page.
  __device__ void gather_pages(const int* table_row, int nt, int Pt, int ppt) {
    int e = s.next_entry, n = 0;
    while (n < ppt && e < nt) {
      const int idx = e + lane;
      const int pg = idx < nt ? __ldg(table_row + idx) : Pt - 1;
      const bool live = pg >= 0 && pg != Pt - 1;
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      const int need = ppt - n;
      const int rank = __popc(mask & ((1u << lane) - 1u));
      if (live && rank < need) s.page[n + rank] = pg;
      const int got = __popc(mask);
      if (got >= need) {
        e += __ffs(__ballot_sync(0xffffffffu, live && rank == need - 1));  // past the last taken
        n = ppt;
      } else {
        e += 32;
        n += got;
      }
    }
    if (lane == 0) {
      s.next_entry = min(e, nt);
      s.n_pages = n;
    }
  }

  // Every live page of the table row; pool keys at positions >= mask_from
  // are masked (the prefill chunk's own positions).
  template <typename KV>
  __device__ void attend_pool(const KV& pool, const int* kpos, const int* table_row,
                              int nt, int ps, int Pt, int Hkv, int h, int mask_from) {
    const int ppt = KT / ps;
    if (tid == 0) s.next_entry = 0;
    __syncthreads();
    while (true) {
      if (warp == 0) gather_pages(table_row, nt, Pt, ppt);
      __syncthreads();
      const int nk = s.n_pages * ps;
      if (nk == 0) break;
      if (tid < nk) {
        const int pos = __ldg(kpos + (size_t)s.page[tid / ps] * ps + tid % ps);
        s.kp[tid] = pos >= mask_from ? -1 : pos;
      }
      if (!tile_live(nk)) continue;
      stage(pool, Hkv, h, nk, [&](int j) { return s.page[j / ps] * ps + j % ps; });
      process_tile(nk);
    }
  }

  // Keys 0 .. n_keys - 1 of a contiguous cache whose key t is row row0 + t,
  // with positions kpos_row[t] (-1 = empty slot).
  template <typename KV>
  __device__ void attend_contiguous(const KV& cache, const int* kpos_row, int n_keys, size_t row0,
                                    int Hkv, int h) {
    for (int t0 = 0; t0 < n_keys; t0 += KT) {
      const int nk = min(KT, n_keys - t0);
      __syncthreads();  // the previous tile is consumed
      if (tid < nk) s.kp[tid] = __ldg(kpos_row + t0 + tid);
      if (!tile_live(nk)) continue;
      stage(cache, Hkv, h, nk, [&](int j) { return row0 + t0 + j; });
      process_tile(nk);
    }
  }

  // The chunk's own keys ck/cv [C, Hkv, DH] at the query positions.
  __device__ void attend_chunk(const T* ck, const T* cv, const int* qpos, int C, int Hkv, int h) {
    for (int j0 = 0; j0 < C; j0 += KT) {
      const int nk = min(KT, C - j0);
      __syncthreads();  // the previous tile is consumed
      if (tid < nk) s.kp[tid] = qpos[j0 + tid];
      if (!tile_live(nk)) continue;
      stage(KVfp<T>{ck, cv}, Hkv, h, nk, [&](int j) { return j0 + j; });
      process_tile(nk);
    }
  }

  // out [tokens, Hkv, G, DH], rows as in load_queries.
  __device__ void store(T* out, int Hkv, int h, int G, int row0) {
    const int d = tid % DH, r0 = tid / DH;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i * RSTEP;
      if (r < nrows) {
        const int rg = row0 + r, c = rg / G, g = rg - c * G;
        out[((size_t)(c * Hkv + h) * G + g) * DH + d] = from_f32<T>(acc[i] / fmaxf(s.l[r], 1e-30f));
      }
    }
  }
};

}  // namespace paged
