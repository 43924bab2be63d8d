// Warp-level tensor-core and async-copy helpers for Hopper, sm_90a, shared by
// the kernels that tile attention on the tensor cores: flash_attention.cu
// (kernel 6), paged_mma.cuh (the bf16 and int8 paths of the paged decode
// and chunk-prefill kernels 7 / 7q and 8 / 8q, and kernel 9 below dh 256)
// and decode_attention_quant.cu (kernel 9 at dh 256).
//
//   * cp.async: 16 (or 4) bytes global -> shared without passing through registers,
//     grouped by commit and awaited as a whole, so a tile's load stays in
//     flight while the block computes on the previous one;
//   * ldmatrix (.trans): four 8 x 8 b16 matrices from shared memory into the
//     fragment layout of mma.sync; the 8 row addresses of each matrix must
//     fall on distinct banks (rows padded by 16 bytes);
//   * mma.sync m16n8k16, bf16 in and f32 accumulate;
//   * int8 widened to bf16 exactly, four values at a time;
//   * a bitmask walk over key tiles (the tiles a block found live);
//   * a block's live and full tiles from a contiguous row's key positions,
//     read in bulk (kernels 6 and 9).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; ok = false zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously (a position or a scale).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a bf16 pair (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four int8 values (one word, little-endian) as two bf16 pairs, exactly and
// without an int-to-float conversion: each byte, biased by 128, becomes the
// low byte of the f32 2^23 + byte, and subtracting 2^23 + 128 leaves the
// value in f32, whose top 16 bits are its bf16 (exact for |value| <= 256).
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The first marked tile >= j of a bitmask over nT tiles, or nT.
__device__ __forceinline__ int next_live(const unsigned* live, int j, int nT) {
  if (j >= nT) return nT;
  const int nw = (nT + 31) >> 5;
  int w = j >> 5;
  unsigned bits = live[w] & (~0u << (j & 31));
  while (!bits) {
    if (++w >= nw) return nT;
    bits = live[w];
  }
  return w * 32 + __ffs(bits) - 1;  // no bit past nT is set
}

// Mark, among the ceil(n / TILE) tiles of TILE keys of a contiguous row of
// key positions kpos[0 .. n) (keys past n invalid; at most 32 * words
// tiles), those that may hold a key valid for a query at some position in
// [lo, hi] (live: kpos >= 0, causal kpos <= hi, window kpos > lo - window)
// and those whose every key is valid for every such query (full), exactly,
// key by key.  Every thread of the block calls it (whole warps); it starts
// and ends on a barrier.  A warp takes U * 32 consecutive keys at a time,
// all in flight before it reduces any, and sets their tiles' bits with one
// atomic per bitmask, so a row of 16384 keys costs a block a few round
// trips to L2 and few contended atomics.
template <int TILE, int U>
__device__ void mark_tiles(const int* __restrict__ kpos, int n, int lo, int hi, int causal,
                           int window, unsigned* live, unsigned* full, int words) {
  constexpr int PER = 32 * U / TILE;  // tiles a warp takes at a time
  static_assert(TILE % 32 == 0 && 32 * U % TILE == 0 && 32 % PER == 0,
                "a warp's keys cover whole tiles within one bitmask word");
  const int tid = threadIdx.x, lane = tid & 31, nth = blockDim.x;
  const int nT = (n + TILE - 1) / TILE, nk = nT * TILE;
  for (int w = tid; w < words; w += nth) {
    const int m = min(32, max(0, nT - w * 32));
    live[w] = 0u;
    full[w] = m == 32 ? ~0u : (1u << m) - 1u;
  }
  __syncthreads();
  for (int base = (tid >> 5) * 32 * U; base < nk; base += nth * U) {
    int kp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * 32 + lane;
      kp[u] = i < n ? __ldg(kpos + i) : -1;
    }
    unsigned lb = 0u, nb = 0u;  // live, and not full, from tile base / TILE on
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u * 32 < nk) {  // the same for the whole warp
        const bool may = kp[u] >= 0 && (!causal || kp[u] <= hi) && (window <= 0 || kp[u] > lo - window);
        const bool all = kp[u] >= 0 && (!causal || kp[u] <= lo) && (window <= 0 || kp[u] > hi - window);
        const unsigned mb = __ballot_sync(0xffffffffu, may), ab = __ballot_sync(0xffffffffu, all);
        if (mb) lb |= 1u << (u * 32 / TILE);
        if (ab != 0xffffffffu) nb |= 1u << (u * 32 / TILE);
      }
    }
    const int t0 = base / TILE;
    if (lane == 0 && lb) atomicOr(&live[t0 >> 5], lb << (t0 & 31));
    if (lane == 0 && nb) atomicAnd(&full[t0 >> 5], ~(nb << (t0 & 31)));
  }
  __syncthreads();
}

}  // namespace sm90
