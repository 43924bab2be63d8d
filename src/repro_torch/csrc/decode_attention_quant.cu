// Decode attention over a contiguous int8 KV cache for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/attention_quant.py::decode_attention_quant
// (its pallas_call), kernel 9.  One decode token per slot attends over its
// row of a contiguous cache stored as int8 values with one f32 scale per
// (timestep, kv-head), quantized when each token was written
// (repro_torch/quant/kv.py):
//
//   q [B, Hkv, G, dh], kq/vq int8 [B, T, Hkv, dh], ks/vs f32 [B, T, Hkv, 1],
//   kpos [B, T] int32 (absolute position per slot, -1 empty), qpos [B] int32
//   -> out [B, Hkv, G, dh]
//
// with validity (kpos >= 0) / causal / window masks, softcap, f32 scores,
// softmax and accumulation, output in the input type.  Masked entries get
// probability 0 explicitly, as in kernels 7 and 8, so a row with no valid key
// gives 0.  The TPU kernel lacks that guard (attention_quant.py:69) and gives
// such a row a uniform average; the engines never read one (a decode token
// always sees itself).
//
// Head dims 32, 64, 128 and 256 (recurrentgemma-2b's int8 rings).
//
// bf16 (the served path) at head dims up to 128: kernel 7q's split-K tile
// walk (paged_mma.cuh) over the contiguous row, which it reads as implicit
// pages of 64 keys (key i of row b is cache row b * T + i; no table, no
// compaction; windows of 256 tiles, 16384 keys).
//   1. Grid (Hkv, B, splits).  Every block of a row reads the row's
//      positions in bulk (mma_sm90.cuh's mark_tiles) and marks the 64-key
//      tiles that hold a key valid for the query (kpos >= 0, causal, inside
//      the window) and those whose every key is valid (no per-entry mask
//      there).  Liveness comes from the positions, never from the slot
//      index, so a window layer's ring whose live slots wrap and a static
//      cache sized max_prefill + max_decode but mostly empty both read only
//      the tiles that hold a valid key.
//   2. The block of split s takes the live tiles of rank
//      [s * L / splits, (s + 1) * L / splits) of a window's L.
//   3. K/V tiles (int8, zero-filled past T), their positions (-1 past T) and
//      per-key scales (one 4-byte cp.async each: a head's scales are strided
//      by Hkv floats) are double-buffered with cp.async; int8 lands raw and
//      is widened exactly in shared memory (mma_sm90.cuh's int8x4_to_bf16).
//      K's scale goes on the score column and V's is folded into P before P
//      is rounded to bf16, so the products are (q . k) * s_k and
//      sum p * s_v * v in f32, as the TPU kernel's f32 dequantization.
//   4. S = Q K^T and P V on mma.sync m16n8k16 (bf16 in, f32 accumulate), the
//      G <= 16 query heads of the kv-head as one 16-row A tile; each warp
//      takes 16 keys of a tile with its own online softmax; the warps merge
//      in shared memory and the block writes f32 partials (m, l, the
//      unnormalised accumulator) to the wrapper's workspace, merged by
//      paged_mma::merge_splits, a second launch; one split writes out
//      itself.
// The split count comes from static shapes only (the wrapper's
// decode_splits over ceil(T / 64) tiles: about two blocks per SM, never more
// splits than tiles), so the call reads no device value on the host and can
// be captured in a CUDA graph.
//
// bf16 at head dim 256 (d256 below): the same grid, marks and rank split,
// but a thread cannot hold 16 k-steps of query fragments beside 128 f32
// accumulators, and a bf16 copy of each tile in shared memory (as above)
// would leave one block of 4 latency-bound warps to an SM.  So:
//   * 8 warps split the work two ways: for S = Q K^T each takes 8 keys of a
//     tile, with the query fragments in registers for the whole walk (64 a
//     thread); for P V each takes 32 of the 256 output columns (16 f32 a
//     thread), reading the tile's P (bf16, V's scale folded in) from shared
//     memory.  The warps share one running max per row (a max over the
//     warps' tile maxima through shared memory), so their sums add without
//     a rescale;
//   * int8 K/V are widened in registers, exactly (int8x4_to_bf16), with no
//     bf16 copy: the fragment orders are permuted (the query's dims, P's
//     keys) so that one 4-byte word of K is one B fragment, and a byte
//     transpose of four keys' words gives V's fragments of four dims; the
//     16-byte chunks of a row are swizzled so both reads hit distinct banks;
//   * shared memory is the two int8 stages and P, 68 KB; decode_splits at
//     dh 256 takes one wave of one block per SM over the B * Hkv rows (16
//     splits at 8 rows, at most 32), so a block walks a few tiles with the
//     next one's loads in flight and the partials shrink (8 and 32 splits
//     were slower at 8 x 2048);
//   * each block stages its accumulators through shared memory and writes
//     its partials (or, at one split, the output) coalesced; the merge is a
//     kernel of its own (merge_kernel), a block a row, whose every thread
//     loads all the splits' values of its column before the weights are
//     known: about one round trip to memory, where paged_mma's merge_splits
//     walks the splits one after another.  It stays a second launch, with
//     no atomics, so the call is deterministic and capturable.
//
// f32 (reduced checks): unsplit, one block per (kv-head, slot) on CUDA cores,
// paged_attention.cuh's Attn walking the row's keys in order.
//
// Bound: the keys the query attends to are read once, dh + 4 bytes each of K
// and of V per kv-head (half the bytes of a bf16 cache at dh = 128), plus
// every slot's position; 4 * H * dh operations per unmasked (query, key)
// pair, about one per byte, far below the card's 295 operations per byte, so
// the least time is those bytes over 3.35 TB/s.  What remains above it: a
// block keeps one tile in flight beside the one it computes, every split
// reads the row's positions before its first tile, and the merge launch and
// the partials' round trip cost a few microseconds that a short row does
// not amortise (PERF.md holds the measured times).
#include "paged_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// bf16: split-K on tensor cores (paged_mma.cuh), then the merge
// ---------------------------------------------------------------------------

struct Params {
  const bf16* q;
  const int8_t* kq;
  const float* ks;
  const int8_t* vq;
  const float* vs;
  const int* kpos;
  const int* qpos;
  bf16* out;
  float* ws;  // split-K partials (paged_mma::partial_m / _l / _acc), R = B * Hkv * G rows
  int B, Hkv, G, T;
  paged::Mask mk;
};

template <int DH>
__global__ void __launch_bounds__(paged_mma::NT) decode_quant_split_kernel(const Params p) {
  using namespace paged_mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t key0 = (size_t)b * p.T;  // the row's first cache row
  const Src src{p.kq + key0 * p.Hkv * DH, p.vq + key0 * p.Hkv * DH, p.ks + key0 * p.Hkv,
                p.vs + key0 * p.Hkv, p.kpos + key0, nullptr, nullptr, nullptr, nullptr,
                BK, 0, p.Hkv, h, 0, INT_MAX, p.T};
  const size_t row0 = ((size_t)b * p.Hkv + h) * p.G;
  decode_block<DH, true, 1>(*reinterpret_cast<Smem<DH, true, 1>*>(smem_raw), src, p.q + row0 * DH,
                            p.G, __ldg(p.qpos + b), p.mk, true, (p.T + BK - 1) / BK, blockIdx.z,
                            gridDim.z, p.out, p.ws, (size_t)p.B * p.Hkv * p.G, row0);
}

template <int DH>
int launch_split(const Params& p, int splits, cudaStream_t stream) {
  const int smem = (int)sizeof(paged_mma::Smem<DH, true, 1>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_quant_split_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  decode_quant_split_kernel<DH><<<dim3(p.Hkv, p.B, splits), paged_mma::NT, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return paged_mma::launch_merge<DH>(p.ws, p.out, p.B * p.Hkv * p.G, splits, stream);
}

// ---------------------------------------------------------------------------
// bf16, head dim 256: split-K with int8 widened in registers
// ---------------------------------------------------------------------------

namespace d256 {

using namespace sm90;
constexpr int DH = 256;
constexpr int BK = paged_mma::BK;       // keys per tile
constexpr int NW = 8, NT = NW * 32;
constexpr int KW = BK / NW;             // keys of a tile a warp scores (S = Q K^T)
constexpr int CW = DH / NW;             // output columns a warp accumulates (P V)
constexpr int ST = 2;                   // int8 K/V stages in flight
constexpr int MAX_SPLITS = 32;          // the merge's splits a row (decode_splits caps them)
constexpr int GR = paged_mma::GR;       // query rows: the G <= 16 heads, one fragment
constexpr int PLD = BK + 16;            // P row (bf16), padded: 8-byte fragment reads on distinct banks
constexpr int MAXL = paged_mma::MAXL;   // tiles marked and split per window
constexpr int WORDS = paged_mma::WORDS;

struct Smem {
  alignas(16) int8_t k[ST][BK][DH];  // 16-byte chunks of a row swizzled (swz)
  alignas(16) int8_t v[ST][BK][DH];
  float ks[ST][BK], vs[ST][BK];      // per-key scales (0 past the window's keys)
  int kp[ST][BK];                    // key positions, -1 past the window's keys
  alignas(16) bf16 p[GR][PLD];       // the tile's probabilities, V's scale folded in
  float wmax[NW][GR];                // each warp's row max over its KW keys of a tile
  float wl[NW][GR];                  // each warp's normaliser at the end
  float m[GR];
  unsigned live[WORDS], full[WORDS];
};

// The 16-byte chunk of row r (a key) that holds logical chunk c: c ^ swz(r),
// so an S fragment read (16 bytes of two neighbouring keys) and a P V read
// (4 bytes of 32 dims of four keys 1 apart, for four keys 4 apart) hit
// distinct banks.
__device__ __forceinline__ int swz(int r) { return ((r >> 1) & 6) ^ ((r & 1) << 2); }

struct Args {
  const bf16* q;       // the row's G query rows [G, DH]
  const int8_t* kq;    // the row's first key of kv-head h: stride Hkv * DH a key
  const int8_t* vq;
  const float* ks;     // stride Hkv a key
  const float* vs;
  const int* kpos;     // the row's positions [T]
  int Hkv, G, T, qp;
};

// One split of one (slot, kv-head) row.  Warp w computes S = Q K^T for keys
// KW w .. KW w + KW - 1 of a tile with its Q fragments in registers, and P V
// for output columns CW w .. CW w + CW - 1 with P from shared memory; the
// warps share one running max per row, so their sums add without a rescale.
//
// Fragment orders (mma.sync m16n8k16): an S k-step's logical dims 2c, 2c + 1,
// 2c + 8, 2c + 9 of thread c are real dims 4c .. 4c + 3 of a 16-dim word
// group (Q's fragments are loaded in that order), so one 4-byte int8 word of
// K is one B fragment; a P V k-step's logical keys are real keys 4c .. 4c + 3
// likewise (P read in that order), and a byte transpose of four keys' words
// gives the B fragments of four dims.  Column g of P V n-tile (cg, u) of
// warp w is dim CW w + 32 cg + 4 g + u.
__device__ __forceinline__ void split_row(Smem& s, const Args& a, const paged::Mask& mk, int sp,
                                          int S, bf16* out, float* ws, size_t R, size_t row0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane >> 2, c = lane & 3;  // fragment row (and r + 8), and column pair

  // Q fragments for the 16 k-steps, from global memory, in the S order
  uint32_t qf[16][4];
#pragma unroll
  for (int qg = 0; qg < 4; ++qg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      uint4 x0 = make_uint4(0, 0, 0, 0), x1 = x0;
      if (row < a.G) {
        const uint4* src = reinterpret_cast<const uint4*>(a.q + row * DH + 64 * qg + 16 * c);
        x0 = __ldg(src);
        x1 = __ldg(src + 1);
      }
      const uint32_t w[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qf[4 * qg + u][h] = w[2 * u];
        qf[4 * qg + u][2 + h] = w[2 * u + 1];
      }
    }
  }

  float m[2] = {paged::NEG_INF, paged::NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's share of this warp's keys
  float o[CW / 32][4][4];
#pragma unroll
  for (int cg = 0; cg < CW / 32; ++cg)
#pragma unroll
    for (int u = 0; u < 4; ++u) o[cg][u][0] = o[cg][u][1] = o[cg][u][2] = o[cg][u][3] = 0.f;

  const int nt = (a.T + BK - 1) / BK;
  for (int e0 = 0; e0 < nt; e0 += MAXL) {
    const int e1 = min(nt, e0 + MAXL), k0 = e0 * BK;
    const int n = min(a.T - k0, (e1 - e0) * BK), nT = (n + BK - 1) / BK;
    __syncthreads();  // the last window's reads of the marks and stages are done
    mark_tiles<BK, 8>(a.kpos + k0, n, a.qp, a.qp, mk.causal, mk.window, s.live, s.full, WORDS);
    int L = 0;
    for (int w = 0; w < WORDS; ++w) L += __popc(s.live[w]);
    const int cnt = (sp + 1) * L / S - sp * L / S;  // L <= MAXL: no overflow
    int j = next_live(s.live, 0, nT);
    for (int i = sp * L / S; i > 0; --i) j = next_live(s.live, j + 1, nT);

    // tile jt's int8 K/V, scales and positions into stage st (one commit group)
    auto load = [&](int jt, int st) {
      for (int i = tid; i < BK * DH / 16; i += NT) {
        const int kr = i >> 4, ch = i & 15, key = jt * BK + kr;
        const bool ok = key < n;
        const size_t off = ok ? (size_t)(k0 + key) * a.Hkv * DH + ch * 16 : 0;
        cp_async16(&s.k[st][kr][(ch ^ swz(kr)) * 16], a.kq + off, ok);
        cp_async16(&s.v[st][kr][(ch ^ swz(kr)) * 16], a.vq + off, ok);
      }
      if (tid < BK) {
        const int key = jt * BK + tid;
        if (key < n) {
          cp_async4(&s.kp[st][tid], a.kpos + k0 + key);
          cp_async4(&s.ks[st][tid], a.ks + (size_t)(k0 + key) * a.Hkv);
          cp_async4(&s.vs[st][tid], a.vs + (size_t)(k0 + key) * a.Hkv);
        } else {
          s.kp[st][tid] = -1;
          s.ks[st][tid] = s.vs[st][tid] = 0.f;
        }
      }
      cp_async_commit();
    };
    int jl = j;  // the next tile to load
    for (int i = 0; i < min(ST, cnt); ++i) {
      load(jl, i);
      jl = next_live(s.live, jl + 1, nT);
    }

    for (int i = 0; i < cnt; ++i) {
      const int st = i % ST;
      if (i == 0 && cnt > 1)
        cp_async_wait_group<1>();
      else
        cp_async_wait_group<0>();
      __syncthreads();  // tile i has landed for every thread; tile i - 1 is consumed
      if (i >= 1 && i + 1 < cnt) {
        load(jl, (i + 1) % ST);  // into tile i - 1's stage
        jl = next_live(s.live, jl + 1, nT);
      }

      // S = Q K^T for this warp's KW keys (n-tiles of 8)
      float sc[KW / 8][4];
#pragma unroll
      for (int t = 0; t < KW / 8; ++t) {
        sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
        const int kr = KW * warp + 8 * t + r;
#pragma unroll
        for (int qg = 0; qg < 4; ++qg) {
          const uint4 kw = *reinterpret_cast<const uint4*>(&s.k[st][kr][((4 * qg + c) ^ swz(kr)) * 16]);
          const uint32_t w[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t b0, b1;
            int8x4_to_bf16(w[u], b0, b1);
            mma_bf16(sc[t], qf[4 * qg + u], b0, b1);
          }
        }
      }

      // scale (K's per-key scale, then scale and softcap), mask, this warp's row max
      float mx[2] = {paged::NEG_INF, paged::NEG_INF};
      unsigned valid = 0;  // bit 4 t + e
#pragma unroll
      for (int t = 0; t < KW / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = KW * warp + 8 * t + 2 * c + (e & 1);
          if (mk.valid(s.kp[st][key], a.qp)) {
            valid |= 1u << (4 * t + e);
            sc[t][e] = mk.score(sc[t][e] * s.ks[st][key]);
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        if (c == 0) s.wmax[warp][r + 8 * h] = mx[h];
      }
      __syncthreads();
      // the tile's max over the warps, the same in every warp
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tm = s.wmax[0][r + 8 * h];
#pragma unroll
        for (int w = 1; w < NW; ++w) tm = fmaxf(tm, s.wmax[w][r + 8 * h]);
        const float m_new = fmaxf(m[h], tm);
        alpha[h] = __expf(m[h] - m_new);  // 1 while no valid key was seen
        m[h] = m_new;
        l[h] *= alpha[h];
      }
      // P = exp(s - m), 0 where masked; V's scale folded in before the bf16 rounding
#pragma unroll
      for (int t = 0; t < KW / 8; ++t) {
        const int key = KW * warp + 8 * t + 2 * c;
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = (valid >> (4 * t + e)) & 1u ? __expf(sc[t][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += pe;
          pv[e] = pe == 0.f ? 0.f : pe * s.vs[st][key + (e & 1)];
        }
        *reinterpret_cast<uint32_t*>(&s.p[r][key]) = pack_bf16(pv[0], pv[1]);
        *reinterpret_cast<uint32_t*>(&s.p[r + 8][key]) = pack_bf16(pv[2], pv[3]);
      }
      __syncthreads();

      // O = alpha O + P V for this warp's CW columns
#pragma unroll
      for (int cg = 0; cg < CW / 32; ++cg)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          o[cg][u][0] *= alpha[0];
          o[cg][u][1] *= alpha[0];
          o[cg][u][2] *= alpha[1];
          o[cg][u][3] *= alpha[1];
        }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint2 p0 = *reinterpret_cast<const uint2*>(&s.p[r][16 * kk + 4 * c]);
        const uint2 p1 = *reinterpret_cast<const uint2*>(&s.p[r + 8][16 * kk + 4 * c]);
        const uint32_t pa[4] = {p0.x, p1.x, p0.y, p1.y};
#pragma unroll
        for (int cg = 0; cg < CW / 32; ++cg) {
          const int col = CW * warp + 32 * cg + 4 * r;  // this thread's four dims
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = 16 * kk + 4 * c + e;
            w[e] = *reinterpret_cast<const uint32_t*>(
                &s.v[st][kr][(((col >> 4) ^ swz(kr)) << 4) + (col & 15)]);
          }
          // bytes u of keys 4c .. 4c + 3: the int8 B fragment of dim col + u
          const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140), x1 = __byte_perm(w[0], w[1], 0x7362);
          const uint32_t y0 = __byte_perm(w[2], w[3], 0x5140), y1 = __byte_perm(w[2], w[3], 0x7362);
          const uint32_t tb[4] = {__byte_perm(x0, y0, 0x5410), __byte_perm(x0, y0, 0x7632),
                                  __byte_perm(x1, y1, 0x5410), __byte_perm(x1, y1, 0x7632)};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t b0, b1;
            int8x4_to_bf16(tb[u], b0, b1);
            mma_bf16(o[cg][u], pa, b0, b1);
          }
        }
      }
    }
  }

  // the warps' normalisers (one running max), then the accumulators through
  // shared memory for coalesced stores
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (c == 0) s.wl[warp][r + 8 * h] = l[h];
    if (c == 0 && warp == 0) s.m[r + 8 * h] = m[h];
  }
  __syncthreads();  // the walk is done: the K stages are free
  float(*acc)[DH] = reinterpret_cast<float(*)[DH]>(&s.k[0][0][0]);
#pragma unroll
  for (int cg = 0; cg < CW / 32; ++cg)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[r + 8 * (e >> 1)][CW * warp + 32 * cg + 4 * (2 * c + (e & 1)) + u] = o[cg][u][e];
  __syncthreads();
  for (int i = tid; i < a.G * DH; i += NT) {
    const int g = i / DH, d = i - g * DH;
    float z = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) z += s.wl[w][g];
    if (S == 1) {
      out[(row0 + g) * DH + d] = __float2bfloat16(acc[g][d] / fmaxf(z, 1e-30f));
      continue;
    }
    paged_mma::partial_acc<DH>(ws, R, S, sp)[(row0 + g) * DH + d] = acc[g][d];
    if (d == 0) {
      paged_mma::partial_m(ws, R, sp)[row0 + g] = s.m[g];
      paged_mma::partial_l(ws, R, S, sp)[row0 + g] = z;
    }
  }
}

__global__ void __launch_bounds__(NT, 1) split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t key0 = (size_t)b * p.T;  // the row's first cache row
  const size_t row0 = ((size_t)b * p.Hkv + h) * p.G;
  const Args a{p.q + row0 * DH, p.kq + (key0 * p.Hkv + h) * DH, p.vq + (key0 * p.Hkv + h) * DH,
               p.ks + key0 * p.Hkv + h, p.vs + key0 * p.Hkv + h, p.kpos + key0, p.Hkv, p.G, p.T,
               __ldg(p.qpos + b)};
  split_row(*reinterpret_cast<Smem*>(smem_raw), a, p.mk, blockIdx.z, gridDim.z, p.out, p.ws,
            (size_t)p.B * p.Hkv * p.G, row0);
}

// out[row] = sum_s acc_s e_s / sum_s l_s e_s, e_s = exp(m_s - max_s m_s), over
// the S <= MAX_SPLITS splits' partials (paged_mma's layout): a block of DH
// threads a row, each loading every split's value of its column before the
// weights are known, so a row costs about one round trip to memory
// (paged_mma::merge_splits walks the splits one after another).  A split
// with no valid key adds 0; a row with none gives 0.
__global__ void __launch_bounds__(DH) merge_kernel(const float* __restrict__ ws,
                                                   bf16* __restrict__ out, int R, int S) {
  __shared__ float e[MAX_SPLITS];
  __shared__ float zs;
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  float acc[MAX_SPLITS];
#pragma unroll
  for (int sp = 0; sp < MAX_SPLITS; ++sp)
    acc[sp] = sp < S ? __ldg(ws + 2 * (size_t)S * R + ((size_t)sp * R + row) * DH + d) : 0.f;
  if (d < 32) {  // lane sp: split sp's m and l
    const float m = d < S ? __ldg(ws + (size_t)d * R + row) : paged::NEG_INF;
    const float l = d < S ? __ldg(ws + ((size_t)S + d) * R + row) : 0.f;
    float mx = m;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float w = d < S ? __expf(m - mx) : 0.f;
    float z = l * w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    e[d] = w;
    if (d == 0) zs = z;
  }
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int sp = 0; sp < MAX_SPLITS; ++sp) sum += acc[sp] * e[sp];
  out[row * DH + d] = __float2bfloat16(sum / fmaxf(zs, 1e-30f));
}

int launch(const Params& p, int splits, cudaStream_t stream) {
  if (splits > MAX_SPLITS) return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  static const cudaError_t attr =
      cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  split_kernel<<<dim3(p.Hkv, p.B, splits), NT, smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  merge_kernel<<<p.B * p.Hkv * p.G, DH, 0, stream>>>(p.ws, p.out, p.B * p.Hkv * p.G, splits);
  return cudaGetLastError();
}

}  // namespace d256

int dispatch_split(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
                   const void* kpos, const void* qpos, void* out, void* ws, int B, int Hkv, int G,
                   int dh, int T, int splits, float scale, int causal, int window, float softcap,
                   void* stream) {
  if (G < 1 || G > paged_mma::GR || B < 1 || Hkv < 1 || T < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const Params p{static_cast<const bf16*>(q), static_cast<const int8_t*>(kq),
                 static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
                 static_cast<const float*>(vs), static_cast<const int*>(kpos),
                 static_cast<const int*>(qpos), static_cast<bf16*>(out), static_cast<float*>(ws),
                 B, Hkv, G, T, paged::Mask{scale, softcap, causal, window}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_split<32>(p, splits, st);
    case 64: return launch_split<64>(p, splits, st);
    case 128: return launch_split<128>(p, splits, st);
    case 256: return d256::launch(p, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, the shared code of paged_attention.cuh
// ---------------------------------------------------------------------------

constexpr int RT = 16;   // query rows per block: G <= 16

template <int DH>
constexpr int kThreads = DH > 128 ? DH : 128;  // a multiple of DH

template <int DH>
__global__ void __launch_bounds__(kThreads<DH>) decode_quant_kernel(
    const float* __restrict__ q, const paged::KVq8 cache, const int* __restrict__ kpos,
    const int* __restrict__ qpos, float* __restrict__ out, int Hkv, int G, int T_, paged::Mask mk) {
  using A = paged::Attn<float, DH, RT, kThreads<DH>>;
  extern __shared__ __align__(16) unsigned char smem[];
  A a(*reinterpret_cast<typename A::Smem*>(smem), mk);
  const int h = blockIdx.x, b = blockIdx.y;
  a.load_queries(q, qpos, Hkv, h, G, b * G, G);
  a.attend_contiguous(cache, kpos + (size_t)b * T_, T_, (size_t)b * T_, Hkv, h);
  a.store(out, Hkv, h, G, b * G);
}

template <int DH>
int launch(const void* q, const paged::KVq8& cache, const void* kpos, const void* qpos, void* out,
           int B, int Hkv, int G, int T_, const paged::Mask& mk, void* stream) {
  const int smem = (int)sizeof(typename paged::Attn<float, DH, RT, kThreads<DH>>::Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_quant_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  decode_quant_kernel<DH><<<dim3(Hkv, B), kThreads<DH>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), cache, static_cast<const int*>(kpos),
      static_cast<const int*>(qpos), static_cast<float*>(out), Hkv, G, T_, mk);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
             const void* kpos, const void* qpos, void* out, int B, int Hkv, int G, int dh, int T_,
             float scale, int causal, int window, float softcap, void* stream) {
  if (G < 1 || G > RT || B < 1 || Hkv < 1 || T_ < 1) return cudaErrorInvalidValue;
  const paged::Mask mk{scale, softcap, causal, window};
  const paged::KVq8 cache = paged::kv_q8(kq, ks, vq, vs);
  switch (dh) {
    case 32: return launch<32>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    case 64: return launch<64>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    case 128: return launch<128>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    case 256: return launch<256>(q, cache, kpos, qpos, out, B, Hkv, G, T_, mk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: device pointers, out (and the bf16
// entry's workspace ws of splits * B * Hkv * G * (dh + 2) floats, unused at
// one split) allocated by the caller, stream a cudaStream_t; returns
// cudaGetLastError() (0 = success).
extern "C" int decode_attention_quant_bf16(const void* q, const void* kq, const void* ks,
                                           const void* vq, const void* vs, const void* kpos,
                                           const void* qpos, void* out, void* ws, int B,
                                           int Hkv, int G, int dh, int T, int splits,
                                           float scale, int causal, int window, float softcap,
                                           void* stream) {
  return dispatch_split(q, kq, ks, vq, vs, kpos, qpos, out, ws, B, Hkv, G, dh, T, splits,
                        scale, causal, window, softcap, stream);
}

extern "C" int decode_attention_quant_f32(const void* q, const void* kq, const void* ks,
                                          const void* vq, const void* vs, const void* kpos,
                                          const void* qpos, void* out, int B, int Hkv, int G,
                                          int dh, int T, float scale, int causal, int window,
                                          float softcap, void* stream) {
  return dispatch(q, kq, ks, vq, vs, kpos, qpos, out, B, Hkv, G, dh, T, scale, causal, window,
                  softcap, stream);
}
