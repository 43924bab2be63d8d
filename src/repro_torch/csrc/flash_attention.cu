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
// bf16 (the served path): one block of 4 warps per (query tile of 64 rows,
// query head, batch row); each warp owns 16 query rows.  Tensor cores through
// mma.sync m16n8k16 (bf16 in, f32 accumulate) for both products: Q lives in
// registers as A fragments (ldmatrix, once), S = Q K^T takes K tiles of 64
// keys from shared memory (ldmatrix), the online softmax runs on the S
// accumulators in registers (quad shuffles for the row max), P is rounded to
// bf16 (as _sdpa casts its probabilities to v's type) and reused in
// registers as the A fragment of P V, with V read by ldmatrix.trans.  K/V
// tiles are double-buffered with cp.async (zero-filled past T, so a masked
// key never multiplies garbage).  Rows are padded by 16 bytes so the 8 row
// addresses of an ldmatrix fall on distinct banks.  The query tile is staged
// in the second K buffer, so a block holds 71 KB of shared memory and three
// blocks (12 warps) share an SM, which hides the latency of one warp's
// dependent mma / ldmatrix / shuffle chain behind the others (with a
// separate query buffer and two blocks to an SM, a 16384-token causal
// prefill took more than twice as long: PERF.md, kernel 6).  The G heads of a kv-head
// read the same K/V tiles from L2; query tiles are issued heaviest (last
// causal) first.
//
// f32 (reduced checks): plain FMA on CUDA cores (no TF32), the shared code
// of paged_attention.cuh walking the contiguous rows (16 query rows of one
// kv-head per block, key tiles of 32), as kernel 9 does.
//
// Causal and window skip: before its loop, a bf16 block reads the key
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
// cores (989 TFLOP/s bf16).  This first version uses warp-level mma.sync,
// not wgmma / TMA, and one 64-row tile per block; those are later work.
#include "mma_sm90.cuh"
#include "paged_attention.cuh"

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
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int DH>
struct Smem16 {
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

template <int DH>
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
  for (int i = tid; i < BQ * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8, sq = s0 + r;
    const bool ok = sq < p.S;
    cp_async16(&s.k[1][r][c], Q + (ok ? (((size_t)b * p.S + sq) * p.H + h) * DH + c : 0), ok);
  }
  cp_async_commit();
  if (tid < BQ) s.qp[tid] = s0 + tid < p.S ? __ldg(p.qpos + (size_t)b * p.S + s0 + tid) : 0;
  for (int w = tid; w < MAX_TILE_WORDS; w += NT) s.live[w] = s.full[w] = 0;
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
  {
    const int qp_lo = s.qp_lo, qp_hi = s.qp_hi;
    for (int j = warp; j < nT; j += NW) {
      bool may = false, all = true;
#pragma unroll
      for (int e = 0; e < BK; e += 32) {
        const int t = j * BK + e + lane;
        const int kp = t < p.T ? __ldg(kpos + t) : -1;
        may |= kp >= 0 && (!p.mk.causal || kp <= qp_hi) &&
               (p.mk.window <= 0 || kp > qp_lo - p.mk.window);
        all &= kp >= 0 && (!p.mk.causal || kp <= qp_lo) &&
               (p.mk.window <= 0 || kp > qp_hi - p.mk.window);
      }
      const bool any_may = __any_sync(0xffffffffu, may), all_ok = __all_sync(0xffffffffu, all);
      if (lane == 0 && any_may) atomicOr(&s.live[j >> 5], 1u << (j & 31));
      if (lane == 0 && all_ok) atomicOr(&s.full[j >> 5], 1u << (j & 31));
    }
  }
  __syncthreads();

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
  for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], &s.k[1][warp * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
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
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    bf16* row = out + (((size_t)b * p.S + sq) * p.H + h) * DH + c0;
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8) = pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
}

template <int DH>
int launch_bf16(const Params& p, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem16<DH>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  flash_bf16_kernel<DH><<<dim3((p.S + BQ - 1) / BQ, p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
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
}

template <int DH>
int launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int NTF = DH % 32 == 0 ? 128 : 2 * DH;  // a multiple of both 32 and DH (112 -> 224)
  const int smem = (int)sizeof(typename paged::Attn<float, DH, RT, NTF>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<DH, NTF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  flash_f32_kernel<DH, NTF><<<dim3((p.S * p.G + RT - 1) / RT, p.Hkv, p.B), NTF, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF16>
int dispatch(const void* q, const void* k, const void* v, const void* qpos, const void* kpos,
             void* out, int B, int S, int T, int H, int Hkv, int dh, float scale, int causal,
             int window, float softcap, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || (T + BK - 1) / BK > MAX_TILE_WORDS * 32)
    return cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(qpos), static_cast<const int*>(kpos), out,
                 B, S, T, H, Hkv, H / Hkv, paged::Mask{scale, softcap, causal, window}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return BF16 ? launch_bf16<32>(p, st) : launch_f32<32>(p, st);
    case 64: return BF16 ? launch_bf16<64>(p, st) : launch_f32<64>(p, st);
    case 112: return BF16 ? launch_bf16<112>(p, st) : launch_f32<112>(p, st);
    case 128: return BF16 ? launch_bf16<128>(p, st) : launch_f32<128>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, out allocated by the
// caller, stream a cudaStream_t; returns cudaGetLastError() (0 = success).
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, const void* qpos,
                                    const void* kpos, void* out, int B, int S, int T, int H,
                                    int Hkv, int dh, float scale, int causal, int window,
                                    float softcap, void* stream) {
  return dispatch<true>(q, k, v, qpos, kpos, out, B, S, T, H, Hkv, dh, scale, causal, window,
                        softcap, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, const void* qpos,
                                   const void* kpos, void* out, int B, int S, int T, int H,
                                   int Hkv, int dh, float scale, int causal, int window,
                                   float softcap, void* stream) {
  return dispatch<false>(q, k, v, qpos, kpos, out, B, S, T, H, Hkv, dh, scale, causal, window,
                         softcap, stream);
}
