// Paged chunk-prefill attention for Hopper, sm_90a.
//
// Replaces the TPU kernel
// repro/kernels/attention_prefill_paged.py::paged_prefill_attention (its
// pallas_call), both branches: a full-precision pool (kernel 8) and an int8
// pool with one f32 scale per (key, kv-head) (quantized=True, kernel 8q).
// A chunk of C prompt tokens of one sequence attends over
//
//   1. the pages its block-table row names (earlier chunks), with pool keys
//      at positions >= the chunk start qpos[0] masked, as the TPU kernel
//      does (attention_prefill_paged.py:117-122): those positions are in
//      flight in the chunk and each key counts once;
//   2. the chunk's own in-flight keys ck/cv, causal, in the input type also
//      over an int8 pool: the chunk is quantized only when it is written.
//
//   q [C, Hkv, G, dh], pool k/v [Pt, ps, Hkv, dh] (int8 with scales ks/vs
//   [Pt, ps, Hkv, 1] f32), kpos [Pt, ps] int32, table [nt] int32
//   (pre-clamped), qpos [C] int32, ck/cv [C, Hkv, dh] -> out [C, Hkv, G, dh]
//
// The caller launches it on the PRE-write pool and writes the chunk's K/V
// into its pages afterwards.  The TPU wrapper's extra trash entry in the
// table is a detail of its index maps and is not needed here.
//
// Batched (the engine's batched prefill tick): B rows in one launch, a row
// index on the grid's z axis.  q [B, C, Hkv, G, dh], table [B, nt], qpos
// [B, C] (-1 at padding, all -1 for an inactive row), ck/cv [B, C, Hkv, dh]
// and out, each with its own row stride (in elements); the pools are
// shared.  Each row masks its pool history from its OWN chunk start
// qpos[b, 0], as the JAX batched mode's per-row launches do
// (repro/models/attention.py:342-396).  A padded query (qpos < 0) writes
// exactly 0, and a block whose query tile holds no valid query writes its
// zeros and exits before it loads any K/V.  The single-row entry is the same
// kernel compiled without the batch (a template flag), so it runs the code
// it ran before the batch axis existed.
//
// bf16 (the served path, kernels 8 and 8q): tensor cores, paged_mma.cuh.  One
// block of 4 warps per (kv-head, tile of 64 query rows), row = token * G +
// grouped head, so the G heads of a kv-head share every K/V tile the block
// loads (G = 5 or 16 need no help from L2); each warp owns 16 rows as
// mma.sync A fragments, each row with its own query position in the masks.
// The block compacts the table row's live pages once, marks the live and the
// full key tiles of the pool and of the chunk (pool keys are all before the
// chunk, so with no window every pool tile of whole pages is full and skips
// the per-entry mask; chunk tiles past the block's last query are never
// loaded), and walks the live tiles with the next one's K/V in flight
// (cp.async).  int8 pages are widened to bf16 in shared memory and their
// scales applied to the score column (K) and to P before its rounding (V).
// Blocks are issued last query tile first (most chunk keys).
//
// f32 (reduced checks): plain FMA on CUDA cores, paged_attention.cuh's Attn
// (256 threads, 64 rows a block, 32-key tiles staged as f32, int8 widened
// and scaled in f32).
//
// Bound: the live pages' K/V plus q, ck, cv and out are read or written once;
// the work is 4 * H * dh operations per unmasked (query, key) pair.  At a
// 256-token chunk over about 1000 tokens of history the operations bound it
// at the tensor cores' rate (989 TFLOP/s bf16), in an empty pool the bytes.
// What still holds the bf16 kernel back: at C = 256 and G = 5 the grid is 160
// blocks of 4 warps on 132 SMs, one or two blocks to an SM, and a warp's tile
// (128 dependent mma.sync, the softmax between them) has no other warp on
// its scheduler to hide its latency behind: the query rows and the
// accumulators in registers (about 210 a thread) allow two blocks to an SM.
// Splitting the key tiles over more blocks (as decode does) gained little
// unless registers were capped for three blocks to an SM, which spilled and
// slowed the int8 branch.  Each of the 20 query tiles of a kv-head also
// reads all its K/V from L2.  wgmma over 128-row query tiles (A from
// registers, K/V through TMA) addresses both and is later work.
#include "paged_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16 (fp or int8 pool): tensor cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block: 4 warps x 16

// The batch of a call: B rows and the elements between rows of q and out,
// of ck / cv, of table and of qpos (B = 1, strides 0: one row).  It goes to
// the kernel as an argument of its own: appended to Params (128 -> 160
// bytes) the same kernel body ran 24% slower on an H100 at C = 256 over 1008
// tokens of history (0.107 against 0.086 ms, PERF.md §6), cause not found.
struct Batch {
  int B;
  long long q_bs, ckv_bs;
  int table_bs, qpos_bs;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* kpos;
  const int* table;
  const int* qpos;
  const bf16* ck;
  const bf16* cv;
  void* out;
  int C, Hkv, G, ps, nt, Pt;
  paged::Mask mk;
};

// BATCHED: a row of the batch per grid z index, the early exit of query
// tiles that hold only padding, and a padded query's zero; the single-row
// entry compiles without any of it.
template <int DH, bool Q8, bool BATCHED>
__global__ void __launch_bounds__(paged_mma::NT, 2) prefill_mma_kernel(const Params p,
                                                                        const Batch bt) {
  using namespace paged_mma;
  constexpr int NB = 2;
  using Sm = Smem<DH, Q8, NB>;
  constexpr int KS = DH / 16, CH = DH / 8, NS = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& s = *reinterpret_cast<Sm*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // last query tile first
  const int nrows = min(BQ, p.C * p.G - row0);
  // this block's row of the batch
  const size_t bz = BATCHED ? blockIdx.z : 0;
  const bf16* Q = static_cast<const bf16*>(p.q) + bz * bt.q_bs;
  bf16* out = static_cast<bf16*>(p.out) + bz * bt.q_bs;
  const int* qpos = p.qpos + bz * bt.qpos_bs;
  const int* table = p.table + bz * bt.table_bs;
  const bf16* ck = p.ck + bz * bt.ckv_bs;
  const bf16* cv = p.cv + bz * bt.ckv_bs;

  // the query rows (zero past nrows, never stored) into k[1], and their positions
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool ok = r < nrows;
    size_t off = 0;
    if (ok) {
      const int rg = row0 + r, t = rg / p.G, g = rg - t * p.G;
      off = (((size_t)t * p.Hkv + h) * p.G + g) * DH + c;
    }
    cp_async16(&s.k[NB - 1][r][c], Q + off, ok);
  }
  cp_async_commit();
  if (tid < BQ) s.qp[tid] = tid < nrows ? __ldg(qpos + (row0 + tid) / p.G) : 0;
  __syncthreads();
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < nrows; r += 32) {
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
  if constexpr (BATCHED) {
    __syncthreads();
    if (s.qp_hi < 0) {  // padding or an inactive row only: zeros, no K/V loaded
      cp_async_wait_all();
      for (int i = tid; i < nrows * CH; i += NT) {
        const int r = i / CH, c = (i - r * CH) * 8;
        const int rg = row0 + r, t = rg / p.G, g = rg - t * p.G;
        *reinterpret_cast<uint4*>(out + (((size_t)t * p.Hkv + h) * p.G + g) * DH + c) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      return;
    }
  }
  // (the walk's first barrier publishes qp_lo / qp_hi before it reads them)

  const Src src{p.k, p.v, p.ks, p.vs, p.kpos, table, ck, cv, qpos,
                p.ps, p.Pt, p.Hkv, h, p.C, __ldg(qpos)};
  Tiles<DH, Q8, NB> tiles(s, src, p.mk, true);
  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows: r0 and r0 + 8
  const int qpr[2] = {s.qp[r0], s.qp[r0 + 8]};
  uint32_t qf[KS][4];
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float o[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  tiles.walk(
      p.nt, 0, 1,
      [&]() {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldmatrix_x4(qf[kk], &s.k[NB - 1][warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
      },
      [&](int cb, int b, bool full, int lim) {
        float sc[NS][4];
        scores<DH, NS>(s, cb, 0, qf, sc, lane);
        update<DH, Q8, NS>(s, cb, b, 0, full, lim, p.mk, qpr, sc, m, l, o, lane);
      });

  // normalise (a row with no valid key has l = 0 and o = 0: writes 0; a
  // padded query writes 0) and store
  const int c0 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i;
    if (r >= nrows) continue;
    const int rg = row0 + r, t = rg / p.G, g = rg - t * p.G;
    const float inv = BATCHED && qpr[i] < 0 ? 0.f : 1.f / fmaxf(l[i], 1e-30f);
    bf16* row = out + (((size_t)t * p.Hkv + h) * p.G + g) * DH + c0;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) = pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int DH, bool Q8, bool BATCHED>
int launch_mma(const Params& p, const Batch& bt, cudaStream_t stream) {
  const int smem = (int)sizeof(paged_mma::Smem<DH, Q8, 2>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_mma_kernel<DH, Q8, BATCHED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.Hkv, (p.C * p.G + BQ - 1) / BQ, bt.B);
  prefill_mma_kernel<DH, Q8, BATCHED><<<grid, paged_mma::NT, smem, stream>>>(p, bt);
  return cudaGetLastError();
}

template <bool Q8, bool BATCHED>
int dispatch_mma(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                 const void* kpos, const void* table, const void* qpos, const void* ck,
                 const void* cv, void* out, int C, int Hkv, int G, int dh, int ps, int nt, int Pt,
                 float scale, int causal, int window, float softcap, const Batch& bt,
                 void* stream) {
  if (C < 1 || G < 1 || ps < 1 || ps > paged::KT || Hkv < 1 || nt < 0 || bt.B < 1 ||
      bt.B > 65535)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
                 static_cast<const int*>(kpos), static_cast<const int*>(table),
                 static_cast<const int*>(qpos), static_cast<const bf16*>(ck),
                 static_cast<const bf16*>(cv), out, C, Hkv, G, ps, nt, Pt,
                 paged::Mask{scale, softcap, causal, window}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_mma<32, Q8, BATCHED>(p, bt, st);
    case 64: return launch_mma<64, Q8, BATCHED>(p, bt, st);
    case 128: return launch_mma<128, Q8, BATCHED>(p, bt, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, the shared code of paged_attention.cuh
// ---------------------------------------------------------------------------

constexpr int F32_NT = 256;  // threads per block
constexpr int F32_RT = 64;   // query rows (token x grouped head) per block

template <int DH, typename KV>
__global__ void __launch_bounds__(F32_NT) prefill_kernel(
    const float* __restrict__ q, const KV pool, const int* __restrict__ kpos,
    const int* __restrict__ table, const int* __restrict__ qpos, const float* __restrict__ ck,
    const float* __restrict__ cv, float* __restrict__ out, int C, int Hkv, int G, int ps, int nt,
    int Pt, paged::Mask mk, Batch bt) {
  using A = paged::Attn<float, DH, F32_RT, F32_NT>;
  extern __shared__ __align__(16) unsigned char smem[];
  A a(*reinterpret_cast<typename A::Smem*>(smem), mk);
  const size_t bz = blockIdx.z;  // this block's row of the batch
  q += bz * bt.q_bs;
  out += bz * bt.q_bs;
  table += bz * bt.table_bs;
  qpos += bz * bt.qpos_bs;
  ck += bz * bt.ckv_bs;
  cv += bz * bt.ckv_bs;
  const int h = blockIdx.x, row0 = blockIdx.y * F32_RT;
  a.load_queries(q, qpos, Hkv, h, G, row0, min(F32_RT, C * G - row0));
  if (a.qp_hi >= 0) {  // else padding or an inactive row only: store writes zeros
    a.attend_pool(pool, kpos, table, nt, ps, Pt, Hkv, h, qpos[0]);
    a.attend_chunk(ck, cv, qpos, C, Hkv, h);
  }
  // a padded query (position < 0) writes 0
#pragma unroll
  for (int i = 0; i < A::RPT; ++i) {
    const int r = (int)threadIdx.x / DH + i * A::RSTEP;
    if (r < a.nrows && a.s.qp[r] < 0) a.acc[i] = 0.f;
  }
  a.store(out, Hkv, h, G, row0);
}

template <int DH, typename KV>
int launch(const void* q, const KV& pool, const void* kpos, const void* table, const void* qpos,
           const void* ck, const void* cv, void* out, int C, int Hkv, int G, int ps, int nt, int Pt,
           const paged::Mask& mk, const Batch& bt, void* stream) {
  const int smem = (int)sizeof(typename paged::Attn<float, DH, F32_RT, F32_NT>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      prefill_kernel<DH, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(Hkv, (C * G + F32_RT - 1) / F32_RT, bt.B);
  prefill_kernel<DH, KV><<<grid, F32_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), pool, static_cast<const int*>(kpos),
      static_cast<const int*>(table), static_cast<const int*>(qpos), static_cast<const float*>(ck),
      static_cast<const float*>(cv), static_cast<float*>(out), C, Hkv, G, ps, nt, Pt, mk, bt);
  return cudaGetLastError();
}

template <typename KV>
int dispatch(const void* q, const KV& pool, const void* kpos, const void* table, const void* qpos,
             const void* ck, const void* cv, void* out, int C, int Hkv, int G, int dh, int ps,
             int nt, int Pt, float scale, int causal, int window, float softcap, const Batch& bt,
             void* stream) {
  if (C < 1 || G < 1 || ps < 1 || ps > paged::KT || Hkv < 1 || nt < 0 || bt.B < 1 ||
      bt.B > 65535)
    return cudaErrorInvalidValue;
  const paged::Mask mk{scale, softcap, causal, window};
  switch (dh) {
    case 32: return launch<32>(q, pool, kpos, table, qpos, ck, cv, out, C, Hkv, G, ps, nt, Pt, mk, bt, stream);
    case 64: return launch<64>(q, pool, kpos, table, qpos, ck, cv, out, C, Hkv, G, ps, nt, Pt, mk, bt, stream);
    case 128: return launch<128>(q, pool, kpos, table, qpos, ck, cv, out, C, Hkv, G, ps, nt, Pt, mk, bt, stream);
    default: return cudaErrorInvalidValue;
  }
}

constexpr Batch ONE_ROW{1, 0, 0, 0, 0};

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, out allocated by the
// caller, stream a cudaStream_t; returns cudaGetLastError() (0 = success).
extern "C" int paged_prefill_attention_bf16(const void* q, const void* k, const void* v,
                                            const void* kpos, const void* table, const void* qpos,
                                            const void* ck, const void* cv, void* out, int C,
                                            int Hkv, int G, int dh, int ps, int nt, int Pt,
                                            float scale, int causal, int window, float softcap,
                                            void* stream) {
  return dispatch_mma<false, false>(q, k, nullptr, v, nullptr, kpos, table, qpos, ck, cv, out, C,
                                    Hkv, G, dh, ps, nt, Pt, scale, causal, window, softcap, ONE_ROW,
                                    stream);
}

extern "C" int paged_prefill_attention_f32(const void* q, const void* k, const void* v,
                                           const void* kpos, const void* table, const void* qpos,
                                           const void* ck, const void* cv, void* out, int C,
                                           int Hkv, int G, int dh, int ps, int nt, int Pt,
                                           float scale, int causal, int window, float softcap,
                                           void* stream) {
  return dispatch(q, paged::kv_fp<float>(k, v), kpos, table, qpos, ck, cv, out, C, Hkv, G, dh, ps,
                  nt, Pt, scale, causal, window, softcap, ONE_ROW, stream);
}

// Kernel 8q, the int8 pool: k/v int8 [Pt, ps, Hkv, dh], ks/vs f32 [Pt, ps, Hkv, 1];
// ck/cv stay in the input type.
extern "C" int paged_prefill_attention_int8_bf16(const void* q, const void* k, const void* ks,
                                                 const void* v, const void* vs, const void* kpos,
                                                 const void* table, const void* qpos,
                                                 const void* ck, const void* cv, void* out, int C,
                                                 int Hkv, int G, int dh, int ps, int nt, int Pt,
                                                 float scale, int causal, int window,
                                                 float softcap, void* stream) {
  return dispatch_mma<true, false>(q, k, ks, v, vs, kpos, table, qpos, ck, cv, out, C, Hkv, G, dh,
                                   ps, nt, Pt, scale, causal, window, softcap, ONE_ROW, stream);
}

extern "C" int paged_prefill_attention_int8_f32(const void* q, const void* k, const void* ks,
                                                const void* v, const void* vs, const void* kpos,
                                                const void* table, const void* qpos,
                                                const void* ck, const void* cv, void* out, int C,
                                                int Hkv, int G, int dh, int ps, int nt, int Pt,
                                                float scale, int causal, int window, float softcap,
                                                void* stream) {
  return dispatch(q, paged::kv_q8(k, ks, v, vs), kpos, table, qpos, ck, cv, out, C, Hkv, G, dh, ps,
                  nt, Pt, scale, causal, window, softcap, ONE_ROW, stream);
}

// The batched entries: B rows in one launch, q / out [B, C, Hkv, G, dh], table [B, nt],
// qpos [B, C], ck / cv [B, C, Hkv, dh], with the row strides (elements) q_bs (q and
// out), ckv_bs (ck and cv), table_bs and qpos_bs; the pools are shared.
#define REPRO_BATCH_ARGS int B, long long q_bs, long long ckv_bs, int table_bs, int qpos_bs
#define REPRO_BATCH Batch{B, q_bs, ckv_bs, table_bs, qpos_bs}

extern "C" int paged_prefill_attention_batched_bf16(
    const void* q, const void* k, const void* v, const void* kpos, const void* table,
    const void* qpos, const void* ck, const void* cv, void* out, int C, int Hkv, int G, int dh,
    int ps, int nt, int Pt, float scale, int causal, int window, float softcap, REPRO_BATCH_ARGS,
    void* stream) {
  return dispatch_mma<false, true>(q, k, nullptr, v, nullptr, kpos, table, qpos, ck, cv, out, C,
                                   Hkv, G, dh, ps, nt, Pt, scale, causal, window, softcap,
                                   REPRO_BATCH, stream);
}

extern "C" int paged_prefill_attention_batched_f32(
    const void* q, const void* k, const void* v, const void* kpos, const void* table,
    const void* qpos, const void* ck, const void* cv, void* out, int C, int Hkv, int G, int dh,
    int ps, int nt, int Pt, float scale, int causal, int window, float softcap, REPRO_BATCH_ARGS,
    void* stream) {
  return dispatch(q, paged::kv_fp<float>(k, v), kpos, table, qpos, ck, cv, out, C, Hkv, G, dh, ps,
                  nt, Pt, scale, causal, window, softcap, REPRO_BATCH, stream);
}

extern "C" int paged_prefill_attention_batched_int8_bf16(
    const void* q, const void* k, const void* ks, const void* v, const void* vs, const void* kpos,
    const void* table, const void* qpos, const void* ck, const void* cv, void* out, int C, int Hkv,
    int G, int dh, int ps, int nt, int Pt, float scale, int causal, int window, float softcap,
    REPRO_BATCH_ARGS, void* stream) {
  return dispatch_mma<true, true>(q, k, ks, v, vs, kpos, table, qpos, ck, cv, out, C, Hkv, G, dh,
                                  ps, nt, Pt, scale, causal, window, softcap, REPRO_BATCH, stream);
}

extern "C" int paged_prefill_attention_batched_int8_f32(
    const void* q, const void* k, const void* ks, const void* v, const void* vs, const void* kpos,
    const void* table, const void* qpos, const void* ck, const void* cv, void* out, int C, int Hkv,
    int G, int dh, int ps, int nt, int Pt, float scale, int causal, int window, float softcap,
    REPRO_BATCH_ARGS, void* stream) {
  return dispatch(q, paged::kv_q8(k, ks, v, vs), kpos, table, qpos, ck, cv, out, C, Hkv, G, dh, ps,
                  nt, Pt, scale, causal, window, softcap, REPRO_BATCH, stream);
}
