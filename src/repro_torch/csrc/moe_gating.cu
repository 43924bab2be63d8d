// Fused top-k MoE gating with expert capacity for Hopper, sm_90a.
//
// Replaces the TPU kernel repro/kernels/moe_gating.py::gating_kernel (kernel
// 1, its pallas_call), with the contract of repro/core/gating.py::top_k_gating:
// for router logits [T, E] (f32),
//
//     probs = softmax(logits)                         [T, E] f32 (max, exp, sum, divide)
//     eidx, gate = top-k of probs by k masked argmaxes [T, K] (a tie -> the lowest id)
//     gate /= sum_k gate                               (K > 1 and normalize)
//     pos  = rank of slot t*K + k among the slots of expert eidx[t, k], in slot
//            order (token-major priority: earlier tokens win capacity, and within
//            a token the primary expert first)
//     keep = pos < C;  w = keep ? gate : 0;  pos = keep ? pos : C - 1
//     counts[e] = slots routed to expert e (before capacity)
//
// A TPU grid runs in order, so the TPU kernel carries the per-expert counts from
// one 128-token tile to the next in VMEM.  Blocks on the card run in no order,
// so this runs two passes on the stream:
//   a. softmax and top-k: one warp per token, each lane holding E/32 of the
//      row.  The argmax reduction compares (value, id) pairs, so a tie goes to
//      the lowest expert id as jnp.argmax (and jax.lax.top_k) give it.  Writes
//      probs, eidx and the (renormalised) gate.
//   b. positions: one block, thread e walks the [T*K] expert list in slot order
//      (staged through shared memory) and numbers the slots of expert e.  Exact
//      and deterministic with no atomics; O(E*T*K) shared-memory reads, which is
//      a few microseconds at the served T*K of at most a few thousand.  It also
//      writes keep, zeroes the dropped slots' weight, clamps their position, and
//      writes counts[e], which the expert kernels read (fill = min(counts, C))
//      so that they skip empty experts without a host sync.
//
// Bound: the logits in, probs and the [T, K] outputs out; below a microsecond
// at every served shape, so the two launches' latency sets its time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // tokens per block in pass a
constexpr int MAX_PER_LANE = 16;     // E <= 512
constexpr int MAX_K = 32;            // gate k lives in lane k
constexpr int CHUNK = 2048;          // slots staged per step in pass b
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
topk_kernel(const float* __restrict__ logits, float* __restrict__ probs,
            int32_t* __restrict__ eidx, float* __restrict__ w, int T, int E, int K,
            int normalize) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= T) return;  // whole warps exit together
  const float* row = logits + (size_t)t * E;
  float v[MAX_PER_LANE];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAX_PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? row[e] : -INFINITY;
    m = fmaxf(m, v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_PER_LANE; ++j) {
    if (lane + 32 * j < E) {
      v[j] = expf(v[j] - m);
      s += v[j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(FULL, s, off);
  float* prow = probs + (size_t)t * E;
#pragma unroll
  for (int j = 0; j < MAX_PER_LANE; ++j) {
    const int e = lane + 32 * j;
    if (e < E) {
      v[j] = v[j] / s;
      prow[e] = v[j];
    }
  }
  // k rounds of masked argmax; lane k keeps round k's (gate, id)
  float my_gate = 0.f;
  int my_id = 0;
  for (int k = 0; k < K; ++k) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < MAX_PER_LANE; ++j) {
      const int e = lane + 32 * j;  // increasing: strict > keeps the lane's first max
      if (e < E && v[j] > bv) {
        bv = v[j];
        bi = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == k) {
      my_gate = bv;
      my_id = bi;
    }
#pragma unroll
    for (int j = 0; j < MAX_PER_LANE; ++j)
      if (lane + 32 * j == bi) v[j] = -INFINITY;
  }
  if (normalize && K > 1) {
    float gs = 0.f;  // in k order, the same sum in every lane
    for (int k = 0; k < K; ++k) gs += __shfl_sync(FULL, my_gate, k);
    my_gate = my_gate / gs;
  }
  if (lane < K) {
    eidx[(size_t)t * K + lane] = my_id;
    w[(size_t)t * K + lane] = my_gate;
  }
}

__global__ void positions_kernel(const int32_t* __restrict__ eidx, float* __restrict__ w,
                                 int32_t* __restrict__ pos, uint8_t* __restrict__ keep,
                                 int32_t* __restrict__ counts, int TK, int E, int C) {
  __shared__ int32_t ids[CHUNK];
  for (int e0 = 0; e0 < E; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    int count = 0;
    for (int base = 0; base < TK; base += CHUNK) {
      const int n = min(CHUNK, TK - base);
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += blockDim.x) ids[i] = eidx[base + i];
      __syncthreads();
      if (e < E) {
        for (int i = 0; i < n; ++i) {
          if (ids[i] != e) continue;
          const int slot = base + i;
          const bool kept = count < C;
          pos[slot] = kept ? count : C - 1;
          keep[slot] = kept;
          if (!kept) w[slot] = 0.f;
          ++count;
        }
      }
    }
    if (e < E) counts[e] = count;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors allocated by the caller: logits [T, E] f32 in; probs
// [T, E] f32, eidx [T, K] i32, w [T, K] f32, pos [T, K] i32, keep [T, K] bool
// (one byte each), counts [E] i32 out.  stream is a cudaStream_t.  Returns
// cudaGetLastError() after the launches (0 = success), or cudaErrorInvalidValue
// for a shape the kernel does not take (E > 512, K > 32 or K > E).
extern "C" int moe_gating_f32(const void* logits, void* probs, void* eidx, void* w, void* pos,
                              void* keep, void* counts, int T, int E, int K, int C,
                              int normalize, void* stream) {
  if (T < 1 || E < 1 || E > 32 * MAX_PER_LANE || K < 1 || K > MAX_K || K > E || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  topk_kernel<<<(T + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      static_cast<const float*>(logits), static_cast<float*>(probs), static_cast<int32_t*>(eidx),
      static_cast<float*>(w), T, E, K, normalize);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = min(1024, (E + 31) / 32 * 32);
  positions_kernel<<<1, threads, 0, s>>>(static_cast<const int32_t*>(eidx),
                                         static_cast<float*>(w), static_cast<int32_t*>(pos),
                                         static_cast<uint8_t*>(keep),
                                         static_cast<int32_t*>(counts), T * K, E, C);
  return static_cast<int>(cudaGetLastError());
}
