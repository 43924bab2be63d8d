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
// and the rank of a slot depends on every earlier slot, so the ranks are one
// block's work.  Two steps:
//   a. softmax and top-k: one warp per token, each lane holding PL = E/32
//      (rounded up to 4, 8, 12 or 16, a template argument) of the row.  The
//      argmax reduction compares (value, id) pairs, so a tie goes to the
//      lowest expert id as jnp.argmax (and jax.lax.top_k) give it.  Writes
//      probs, eidx and the (renormalised) gate.
//   b. ranks: a parallel scan over the T*K slots in chunks of the block's
//      width (up to 1024 threads), one slot a thread, in slot order.  In a warp,
//      __match_any_sync on the expert id and a popcount of the lower lanes
//      give a slot's rank among the warp's equal ids; the lowest such lane
//      writes the warp's count of that id into shared memory (a byte per warp
//      and expert); a slot then adds the counts of its id in the earlier
//      warps and the expert's carry from earlier chunks, and the chunk's last
//      slot of each expert advances that carry.  Exact and deterministic, no
//      atomics; three barriers a chunk.  It writes keep, zeroes the dropped
//      slots' weight, clamps their position, and writes counts[e] (the final
//      carries), which the expert kernels read (fill = min(counts, C)) so that
//      they skip empty experts without a host sync.
// One launch (gating_one_kernel, up to the wrapper's slot bound,
// kernels/moe_gating.py::ONE_LAUNCH_SLOTS, which every served shape is
// within): blocks of up to 8 warps run a, a token a warp, then each block
// takes a ticket; the block that takes the last one runs b over every
// block's outputs (the writers fence before their tickets, the reader reads
// past L1) and resets the counter for the next call.  A grid of one block (T
// <= 8: decode) skips the ticket.  The counter is a word of g_tickets that no
// call running at the same time shares (ticket_word): the word of the call's
// stream for a call issued eagerly, as a stream's calls run in order, and a
// word of its own for good for each stream of each CUDA graph capture, as
// replays of two graphs, or a graph and eager calls, may overlap; two
// replays of one graph do not.  Measured on the card (PERF.md): one block
// of 1024 threads running a and b queued a's tokens on one SM (0.026 ms at T
// = 256, 0.097 at kimi-k2's width); blocks of 32 tokens with a ticket took
// 0.0051 / 0.0064 / 0.021 ms at T = 4 / 256 / kimi-k2, behind the two
// launches below (0.0047 / 0.0053 / 0.0146): big blocks put a's tokens on
// few SMs, and every thread's fence and the rank block's 1024 threads cost
// more than a second launch in a graph.  Blocks of 8 tokens (this design)
// take 0.0030 / 0.0050 / 0.0148 ms, the two launches 0.0040 / 0.0045 /
// 0.0144: on one block one launch wins, on more the two launches win by up
// to 10% in a graph, so the one launch past one block is kept only for the
// one launch a served call costs the host.  Two launches (past the bound):
// a on blocks of 8 tokens, b as a second launch of one block reading a's
// outputs, as wide as the slots (up to 1024 threads).
//
// Bound: the logits in, probs and the [T, K] outputs out; below a microsecond
// at every served shape, so a launch's latency sets its time.
//
// Kernel 1b, the backward (gating_bwd_kernel; no TPU kernel: JAX trains
// through the jnp top_k_gating and differentiates it with XLA, and the
// port's autograd cannot pass through this file's launch).  For the
// gradients of combine_w [T, K] (dw) and probs [T, E] (dprobs, from the aux
// loss; may be null), following repro/core/gating.py:67-95:
//
//     dg_k   = keep_k dw_k                                (dropped slots: 0)
//     dp[idx_k] += (dg_k - sum_j dg_j g_j) / s,  s = sum_k p[idx_k], g_k = p[idx_k] / s
//                                                 (normalize and K > 1; else += dg_k)
//     dlogits = p * (dp - sum_e p_e dp_e)         (the softmax's backward), with
//               dp = dprobs + the top-k terms
//
// One warp per token row, PL values a lane as in step a; the K slot terms
// live in lanes 0 .. K - 1, and their sums run in k order.  A row
// reduction: bound by its bytes (probs and dprobs in, dlogits out).  The first
// version took two launches at every shape and walked the slots serially (a
// thread per expert reading all T*K of them).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int WARPS = 8;             // tokens per block of step a
constexpr int THREADS = 1024;        // the widest rank block
constexpr int MAX_PER_LANE = 16;     // E <= 512
constexpr int MAX_E = 32 * MAX_PER_LANE;
constexpr int MAX_K = 32;            // gate k lives in lane k
constexpr unsigned FULL = 0xffffffffu;

// Ticket counters of one-launch calls: word w counts the blocks of its call
// that have finished step a; the last resets it.  Zero at load.
constexpr int TICKETS = 4096;
__device__ unsigned int g_tickets[TICKETS] = {};

// Step a for token t in one warp, PL values a lane (E <= 32 PL): writes
// probs[t]; lane k < K returns the k-th (gate, id).
template <int PL>
__device__ __forceinline__ void topk_row(const float* __restrict__ logits,
                                         float* __restrict__ probs, int t, int E, int K,
                                         int normalize, int lane, float& my_gate, int& my_id) {
  const float* row = logits + (size_t)t * E;
  float v[PL];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? row[e] : -INFINITY;
    m = fmaxf(m, v[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    if (lane + 32 * j < E) {
      v[j] = expf(v[j] - m);
      s += v[j];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(FULL, s, off);
  float* prow = probs + (size_t)t * E;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int e = lane + 32 * j;
    if (e < E) {
      v[j] = v[j] / s;
      prow[e] = v[j];
    }
  }
  // k rounds of masked argmax; lane k keeps round k's (gate, id)
  my_gate = 0.f;
  my_id = 0;
  for (int k = 0; k < K; ++k) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PL; ++j) {
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
    for (int j = 0; j < PL; ++j)
      if (lane + 32 * j == bi) v[j] = -INFINITY;
  }
  if (normalize && K > 1) {
    float gs = 0.f;  // in k order, the same sum in every lane
    for (int k = 0; k < K; ++k) gs += __shfl_sync(FULL, my_gate, k);
    my_gate = my_gate / gs;
  }
}

// Step a on many blocks: one warp per token.
template <int PL>
__global__ void __launch_bounds__(WARPS * 32)
topk_kernel(const float* __restrict__ logits, float* __restrict__ probs,
            int32_t* __restrict__ eidx, float* __restrict__ w, int T, int E, int K,
            int normalize) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= T) return;  // whole warps exit together
  float gate;
  int id;
  topk_row<PL>(logits, probs, t, E, K, normalize, lane, gate, id);
  if (lane < K) {
    eidx[(size_t)t * K + lane] = id;
    w[(size_t)t * K + lane] = gate;
  }
}

// Step b's shared state for a block of up to NW warps: per warp and
// expert, the warp's slots of that expert in the current chunk (at most 32,
// a byte); per expert, the slots of earlier chunks.
template <int NW>
struct Ranks {
  uint8_t cnt[NW][MAX_E];
  int carry[MAX_E];
};

// Step b over slots [0, TK) by the whole block (whole warps, at most
// THREADS): id_of(s) is slot s's expert, out(s, rank) takes its rank;
// counts[e] the slots of expert e.  Starts and ends on a barrier.
template <int NW, class IdOf, class Out>
__device__ __forceinline__ void rank_slots(int TK, int E, Ranks<NW>& sh, IdOf id_of, Out out,
                                           int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = threadIdx.x; i < nw * E; i += blockDim.x) sh.cnt[i / E][i % E] = 0;
  for (int e = threadIdx.x; e < E; e += blockDim.x) sh.carry[e] = 0;
  __syncthreads();
  for (int base = 0; base < TK; base += blockDim.x) {
    const int slot = base + threadIdx.x;
    const int id = slot < TK ? id_of(slot) : -1;
    const unsigned same = __match_any_sync(FULL, id);
    const int lower = __popc(same & ((1u << lane) - 1u));  // equal ids on lower lanes
    const bool lead = id >= 0 && lower == 0;
    if (lead) sh.cnt[warp][id] = static_cast<uint8_t>(__popc(same));
    __syncthreads();
    int rank = 0;
    bool last = false;
    if (id >= 0) {
      int before = 0, after = 0;
      for (int v = 0; v < nw; ++v) {
        const int c = sh.cnt[v][id];
        before += v < warp ? c : 0;
        after += v > warp ? c : 0;
      }
      rank = sh.carry[id] + before + lower;
      last = after == 0 && (same >> lane) == 1u;  // the chunk's last slot of expert id
      out(slot, rank);
    }
    __syncthreads();  // every carry read before it advances
    if (last) sh.carry[id] = rank + 1;
    if (lead) sh.cnt[warp][id] = 0;
    __syncthreads();
  }
  for (int e = threadIdx.x; e < E; e += blockDim.x) counts[e] = sh.carry[e];
}

// Step b on its own (two launches): one block over topk_kernel's outputs.
__global__ void __launch_bounds__(THREADS)
rank_kernel(const int32_t* __restrict__ eidx, float* __restrict__ w, int32_t* __restrict__ pos,
            uint8_t* __restrict__ keep, int32_t* __restrict__ counts, int TK, int E, int C) {
  __shared__ Ranks<THREADS / 32> sh;
  rank_slots(
      TK, E, sh, [&](int s) { return static_cast<int>(__ldg(eidx + s)); },
      [&](int s, int r) {
        const bool kept = r < C;
        pos[s] = kept ? r : C - 1;
        keep[s] = kept;
        if (!kept) w[s] = 0.f;
      },
      counts);
}

// Steps a and b in one launch: blocks of up to WARPS warps, warp v of block
// b taking token WARPS b + v; the block that finishes a last runs b, the
// blocks counted in g_tickets[ticket] (unused with one block).
template <int PL>
__global__ void __launch_bounds__(WARPS * 32)
gating_one_kernel(const float* __restrict__ logits, float* __restrict__ probs,
                  int32_t* __restrict__ eidx, float* __restrict__ w, int32_t* __restrict__ pos,
                  uint8_t* __restrict__ keep, int32_t* __restrict__ counts, int T, int E, int K,
                  int C, int normalize, int ticket) {
  __shared__ Ranks<WARPS> sh;
  __shared__ bool last;
  const int lane = threadIdx.x & 31, t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t < T) {  // whole warps
    float gate;
    int id;
    topk_row<PL>(logits, probs, t, E, K, normalize, lane, gate, id);
    if (lane < K) {
      eidx[(size_t)t * K + lane] = id;
      w[(size_t)t * K + lane] = gate;
      if (gridDim.x > 1) __threadfence();  // visible on the device before the ticket
    }
  }
  if (gridDim.x > 1) {
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&g_tickets[ticket], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  rank_slots(
      T * K, E, sh, [&](int s) { return static_cast<int>(__ldcg(eidx + s)); },
      [&](int s, int r) {
        const bool kept = r < C;
        pos[s] = kept ? r : C - 1;
        keep[s] = kept;
        if (!kept) w[s] = 0.f;
      },
      counts);
  if (threadIdx.x == 0 && gridDim.x > 1) g_tickets[ticket] = 0;
}

// Kernel 1b: one warp per token (blocks of WARPS tokens).
template <int PL>
__global__ void __launch_bounds__(WARPS * 32)
gating_bwd_kernel(const float* __restrict__ probs, const int32_t* __restrict__ eidx,
                  const uint8_t* __restrict__ keep, const float* __restrict__ dw,
                  const float* __restrict__ dprobs, float* __restrict__ dlogits, int T, int E,
                  int K, int normalize) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= T) return;  // whole warps exit together
  const float* prow = probs + (size_t)t * E;
  float p[PL], dp[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int e = lane + 32 * j;
    p[j] = e < E ? prow[e] : 0.f;
    dp[j] = e < E && dprobs != nullptr ? dprobs[(size_t)t * E + e] : 0.f;
  }
  int id = -1;
  float pk = 0.f, dg = 0.f;
  if (lane < K) {
    const size_t slot = (size_t)t * K + lane;
    id = eidx[slot];
    pk = prow[id];
    dg = keep[slot] ? dw[slot] : 0.f;
  }
  float add = dg;
  if (normalize && K > 1) {
    float s = 0.f;  // in k order, the same sum in every lane
    for (int k = 0; k < K; ++k) s += __shfl_sync(FULL, pk, k);
    const float g = pk / s;
    float c = 0.f;
    for (int k = 0; k < K; ++k) c += __shfl_sync(FULL, dg * g, k);
    add = (dg - c) / s;
  }
  for (int k = 0; k < K; ++k) {  // the K ids of a token are distinct
    const int ik = __shfl_sync(FULL, id, k);
    const float ak = __shfl_sync(FULL, add, k);
#pragma unroll
    for (int j = 0; j < PL; ++j)
      if (lane + 32 * j == ik) dp[j] += ak;
  }
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) dot = fmaf(p[j], dp[j], dot);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(FULL, dot, off);
  float* out = dlogits + (size_t)t * E;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int e = lane + 32 * j;
    if (e < E) out[e] = p[j] * (dp[j] - dot);
  }
}

template <int PL>
int launch_bwd(const float* pr, const int32_t* ei, const uint8_t* kp, const float* dw,
               const float* dprobs, float* dl, int T, int E, int K, int normalize, cudaStream_t s) {
  gating_bwd_kernel<PL><<<(T + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(pr, ei, kp, dw, dprobs, dl, T,
                                                                       E, K, normalize);
  return static_cast<int>(cudaGetLastError());
}

// The ticket word of a one-launch call of more than one block on stream s,
// on the current device: one per (device, stream, capture), where an eager
// call's capture is 0 and a captured call's the capture's id (unique in the
// process), handed out in order and kept.  cudaErrorMemoryAllocation once a
// device's TICKETS words are all handed out.
int ticket_word(cudaStream_t s, int* word) {
  cudaStreamCaptureStatus status;
  unsigned long long capture = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &capture);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) capture = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::mutex mu;
  static std::map<std::tuple<int, cudaStream_t, unsigned long long>, int> words;
  static std::map<int, int> taken;  // per device
  std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(dev, s, capture);
  const auto it = words.find(key);
  if (it != words.end()) {
    *word = it->second;
    return 0;
  }
  int& n = taken[dev];
  if (n >= TICKETS) return static_cast<int>(cudaErrorMemoryAllocation);
  *word = n++;
  words.emplace(key, *word);
  return 0;
}

template <int PL>
int launch(const float* lg, float* pr, int32_t* ei, float* wt, int32_t* ps, uint8_t* kp,
           int32_t* ct, int T, int E, int K, int C, int normalize, int one_launch, cudaStream_t s) {
  const int blocks = (T + WARPS - 1) / WARPS;
  if (one_launch) {  // one block of T warps at decode, else blocks of WARPS
    int ticket = 0;
    if (blocks > 1) {
      const int rc = ticket_word(s, &ticket);
      if (rc) return rc;
    }
    gating_one_kernel<PL><<<blocks, 32 * (T < WARPS ? T : WARPS), 0, s>>>(
        lg, pr, ei, wt, ps, kp, ct, T, E, K, C, normalize, ticket);
    return static_cast<int>(cudaGetLastError());
  }
  topk_kernel<PL><<<blocks, WARPS * 32, 0, s>>>(lg, pr, ei, wt, T, E, K, normalize);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slots = (T * K + 31) / 32 * 32;
  rank_kernel<<<1, slots < THREADS ? slots : THREADS, 0, s>>>(ei, wt, ps, kp, ct, T * K, E, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors allocated by the caller: logits [T, E] f32 in; probs
// [T, E] f32, eidx [T, K] i32, w [T, K] f32, pos [T, K] i32, keep [T, K] bool
// (one byte each), counts [E] i32 out.  one_launch: 1 for the one-launch
// kernel, 0 for the many-block top-k and the rank launch.  stream is a
// cudaStream_t.  Returns cudaGetLastError() after the launches (0 =
// success), cudaErrorInvalidValue for a shape the kernel does not take
// (E > 512, K > 32 or K > E), or ticket_word's error.
extern "C" int moe_gating_f32(const void* logits, void* probs, void* eidx, void* w, void* pos,
                              void* keep, void* counts, int T, int E, int K, int C,
                              int normalize, int one_launch, void* stream) {
  if (T < 1 || E < 1 || E > MAX_E || K < 1 || K > MAX_K || K > E || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lg = static_cast<const float*>(logits);
  float* pr = static_cast<float*>(probs);
  int32_t* ei = static_cast<int32_t*>(eidx);
  float* wt = static_cast<float*>(w);
  int32_t* ps = static_cast<int32_t*>(pos);
  uint8_t* kp = static_cast<uint8_t*>(keep);
  int32_t* ct = static_cast<int32_t*>(counts);
  if (E <= 128) return launch<4>(lg, pr, ei, wt, ps, kp, ct, T, E, K, C, normalize, one_launch, s);
  if (E <= 256) return launch<8>(lg, pr, ei, wt, ps, kp, ct, T, E, K, C, normalize, one_launch, s);
  if (E <= 384) return launch<12>(lg, pr, ei, wt, ps, kp, ct, T, E, K, C, normalize, one_launch, s);
  return launch<16>(lg, pr, ei, wt, ps, kp, ct, T, E, K, C, normalize, one_launch, s);
}

// Kernel 1b.  Device pointers of contiguous tensors allocated by the caller:
// probs [T, E] f32, eidx [T, K] i32, keep [T, K] bool (one byte each), dw
// [T, K] f32 and dprobs [T, E] f32 (or null: no aux-loss gradient) in;
// dlogits [T, E] f32 out.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int moe_gating_backward_f32(const void* probs, const void* eidx, const void* keep,
                                       const void* dw, const void* dprobs, void* dlogits, int T,
                                       int E, int K, int normalize, void* stream) {
  if (T < 1 || E < 1 || E > MAX_E || K < 1 || K > MAX_K || K > E)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pr = static_cast<const float*>(probs);
  const int32_t* ei = static_cast<const int32_t*>(eidx);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  const float* gw = static_cast<const float*>(dw);
  const float* gp = static_cast<const float*>(dprobs);
  float* dl = static_cast<float*>(dlogits);
  if (E <= 128) return launch_bwd<4>(pr, ei, kp, gw, gp, dl, T, E, K, normalize, s);
  if (E <= 256) return launch_bwd<8>(pr, ei, kp, gw, gp, dl, T, E, K, normalize, s);
  if (E <= 384) return launch_bwd<12>(pr, ei, kp, gw, gp, dl, T, E, K, normalize, s);
  return launch_bwd<16>(pr, ei, kp, gw, gp, dl, T, E, K, normalize, s);
}
