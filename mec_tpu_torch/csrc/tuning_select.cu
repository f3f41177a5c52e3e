// K2 tuning_select: the selection phase of librosa.estimate_tuning, one
// thread block cluster per clip row of K pitch candidate slots.
//
// Replaces: mec_tpu/ops/pallas_tuning.py::tuning_select_pallas (kernel
// _tuning_kernel). Per row: the masked median of the candidate
// magnitudes (mask = pitch > 0), sel = mags >= median & mask, a 100-bin
// histogram of the selected residuals against the 101 ceil-to-f32 edges
// of audio_features._hist_edges_ceil32, the first argmax, and whether
// anything was selected.
//
// What bounds it on this card: by its bytes (3 x 93 KB per row at the
// serving K = 23,270, 8.9 MB at batch 32) it is a few microseconds of
// streaming, but an exact median is a chain of dependent passes, each
// ending in a barrier, and a clip that sits on one SM leaves the card
// empty. A pass of one block over n keys in shared memory costs 0.2 to
// 0.4 clocks a key however its threads are arranged (ten thousand keys:
// 2 to 4 thousand clocks; ballots, returning atomics, 16-byte loads and
// four keys a step were each tried and moved nothing). So the time is
// the number of passes one block makes over all the kept keys, the
// barriers between them and the SMs that load; not bytes.
//
// Design.
//  * Compact at load. Only slots with pitch > 0 are candidates, a small
//    part of the K slots for tones and speech (four in ten for noise,
//    every slot at worst). The clip's slots are split over the `split`
//    blocks of a cluster; each block streams its slice of the three
//    arrays once (independent loads, six in flight a thread and array,
//    so a cluster of 4 or 8 takes its slice in one sweep) and keeps only
//    the candidates in shared memory, appended a warp at a time (ballots,
//    popcount prefixes, one shared atomic a warp and sweep): the order
//    key of the magnitude and the histogram bin of the residual, found
//    here, under the loads' latency and on every SM of the cluster, by a
//    guess from arithmetic corrected against the same 101 f32 edges, so
//    it is the reference's bin exactly. Nothing is read from device
//    memory twice.
//  * The first digit is counted while streaming. The order key (negative
//    floats -> ~bits, others -> bits | 0x80000000, as
//    audio_features._kth_smallest maps them; -0 counts as +0, which
//    changes no compare) has sign and exponent on top, so the top 12 bits
//    (sign, exponent, three bits of mantissa) spread even one octave of
//    magnitudes over eight bins. Every block counts its candidates' top
//    digits in a 4096-bin histogram as it keeps them, on its own SM, so
//    the first and largest round of the radix select costs no pass.
//  * Gather, then one block. The blocks of ranks 1.. reserve a range in
//    block 0's buffer (one remote atomic a block), copy their kept pairs
//    there through distributed shared memory and add their non-empty
//    histogram bins to block 0's; block 0's own pairs sit at the front
//    of the same buffer, the others' fill it from the back, so K slots
//    of room hold any mix. One cluster barrier, and the cluster has done
//    its work: spreading the load over SMs. A block may write to
//    another's shared memory once that block runs: everyone says so at
//    the start (barrier_arrive) and waits for the others' word before
//    the first remote access (barrier_wait).
//  * Radix select instead of bisection, on a short list. Block 0 scans
//    the 4096 counts for the bin that holds the lower middle's rank, and
//    in one pass over the n kept keys copies that bin's keys (n / 30 or
//    so) to a short list (each warp counts its run's matches, then
//    writes behind the warps below it). Two more rounds of 10 bits, each
//    a histogram over the short list and a scan, pin the same key as the
//    reference's 32 bisection probes. A bin too large for the list (many equal
//    magnitudes) takes the same two rounds over all n keys, filtered by
//    the prefix. A warp adds its leader's digit with one atomic for all
//    the lanes that share it, so tied keys do not serialise.
//  * The upper middle is the lower one or the next larger key: counted
//    and found on the short list, with the scan's count of the bins
//    below; only if that bin holds nothing larger, one pass over all
//    keys. Then one pass over the n pairs selects key >= key(median) and
//    counts each selected pair's bin with shared-memory integer atomics.
//    Counts, minima and integer histograms do not depend on the order of
//    the pairs, so the result is bit-identical to the reference (finite
//    magnitudes) and the same on every run, although the order in the
//    buffer is not.
//    Ties in the argmax go to the lowest bin, as np.argmax does. A NaN
//    or out-of-range residual falls in no bin; no candidate gives median
//    0, bin 0 and has = false.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"
#include "reduce.cuh"
#include "trace.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 100;
constexpr int kUnroll = 6;           // loads in flight a thread and array: a slice of
                                     // a cluster of 4 or 8 is one sweep of the block
constexpr int kMaxSplit = 8;         // the portable cluster size
constexpr int kTopBits = 12;         // the digit counted while streaming
constexpr int kTopDigits = 1 << kTopBits;
constexpr int kLowBits = 10;         // two more rounds: 12 + 10 + 10 = 32
constexpr int kLowDigits = 1 << kLowBits;
constexpr int kShort = 2048;         // room of the short list
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTopDigits % kThreads == 0 && kLowDigits == kThreads,
              "pick_digit gives a thread whole bins");

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) return 0x80000000u;            // -0 is +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// hist[d] += 1 for every lane with pred. The lanes that share the
// digit of the first such lane add it with one atomic, the others one
// each: tied keys cost a ballot, not a queue at one address. Every lane
// of the warp must call it.
__device__ __forceinline__ void warp_hist_add(int* hist, int d, bool pred) {
  const unsigned voters = __ballot_sync(kFull, pred);
  if (voters == 0u) return;
  const int leader = __ffs(voters) - 1;
  const int d0 = __shfl_sync(kFull, d, leader);
  const unsigned same = __ballot_sync(kFull, pred && d == d0);
  if ((int)(threadIdx.x & 31) == leader) atomicAdd(&hist[d0], __popc(same));
  else if (pred && d != d0) atomicAdd(&hist[d], 1);
}

// The bin j with edge[j] <= r < edge[j + 1], or -1: r outside [edge[0],
// edge[kBins]) or NaN falls in no bin, as in the reference. The edges
// are 0.01 apart from -0.5: guess by arithmetic, then step to the bin
// that the table's own compares name.
__device__ __forceinline__ int residual_bin(float r, const float* edge) {
  if (!(r >= edge[0]) || r >= edge[kBins]) return -1;
  int a = min(max((int)((r + 0.5f) * (float)kBins), 0), kBins - 1);
  while (a > 0 && r < edge[a]) --a;
  while (a < kBins - 1 && r >= edge[a + 1]) ++a;
  return a;
}

// The bin of hist (PER consecutive bins a thread, PER * kThreads bins)
// whose run holds rank `target`: pick = {bin, count below it, its
// count}. All threads call it; hist is complete and visible on entry
// (a barrier behind the last add), pick is visible on return.
template <int PER>
__device__ __forceinline__ void pick_digit(const int* hist, int target, int* warp_total,
                                           int* pick) {
  const int tid = threadIdx.x, lane = tid & 31;
  int c[PER], own = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) own += c[j] = hist[tid * PER + j];
  int incl = own;
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_total[tid >> 5] = incl;
  __syncthreads();
  // the warps below: one load a lane and a fold, not a chain of loads
  const int before = mec::warp_sum(lane < (tid >> 5) ? warp_total[lane] : 0);
  int below = before + incl - own;
  if (below <= target && target < below + own) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (below <= target && target < below + c[j]) {
        pick[0] = tid * PER + j;
        pick[1] = below;
        pick[2] = c[j];
      }
      below += c[j];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
tuning_select_kernel(const float* __restrict__ mags,
                     const float* __restrict__ residual,
                     const float* __restrict__ pitches, int K,
                     const float* __restrict__ edges,   // (kBins + 1,)
                     int* __restrict__ best, unsigned char* __restrict__ has) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int clip = blockIdx.x / split;
  const int tid = threadIdx.x, lane = tid & 31;

  extern __shared__ uint32_t keys[];                    // (K,) keys, then (K,) residual bins
  int* rbin = reinterpret_cast<int*>(keys + K);
  __shared__ int hist[kTopDigits];
  __shared__ uint32_t shortlist[kShort];
  __shared__ int n_stage;          // pairs this block kept
  __shared__ int n_remote;         // block 0: pairs the other blocks sent
  __shared__ int push_at;
  __shared__ int warp_total[kWarps];
  __shared__ int pick[3];          // a round's bin, the count below it, its count
  __shared__ float edge[kBins + 1];
  __shared__ int bins[kBins];
  __shared__ int iscratch[kWarps];

  MEC_TRACE_BEGIN()
  MEC_TRACE_MARK()
  if (tid == 0) {
    n_stage = 0;
    n_remote = 0;
  }
  for (int i = tid; i < kTopDigits; i += kThreads) hist[i] = 0;
  cluster.barrier_arrive();        // this block runs, its counters and counts are 0
  for (int i = tid; i <= kBins; i += kThreads) edge[i] = edges[i];
  for (int i = tid; i < kBins; i += kThreads) bins[i] = 0;
  __syncthreads();

  // ---- load this block's slice once, keep the candidates, count top digits
  const int slice = (K + split - 1) / split;
  const int begin = min(rank * slice, K);
  const int len = min(K, begin + slice) - begin;
  const size_t g = (size_t)clip * K + begin;
  for (int b0 = tid - lane; b0 < len; b0 += kThreads * kUnroll) {
    float p[kUnroll], m[kUnroll], r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = b0 + u * kThreads + lane;
      const bool in = i < len;
      p[u] = in ? pitches[g + i] : 0.f;
      m[u] = in ? mags[g + i] : 0.f;
      r[u] = in ? residual[g + i] : 0.f;
    }
    // one reservation a warp and sweep
    unsigned votes[kUnroll];
    int total = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      votes[u] = __ballot_sync(kFull, p[u] > 0.f);
      total += __popc(votes[u]);
    }
    if (total == 0) continue;                           // warp-uniform
    int at = 0;
    if (lane == 0) at = atomicAdd(&n_stage, total);
    at = __shfl_sync(kFull, at, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (votes[u] == 0u) continue;                     // warp-uniform
      const bool cand = (votes[u] >> lane) & 1u;
      const uint32_t key = order_key(m[u]);
      if (cand) {
        const int to = at + __popc(votes[u] & ((1u << lane) - 1u));
        keys[to] = key;
        rbin[to] = residual_bin(r[u], edge);
      }
      at += __popc(votes[u]);
      warp_hist_add(hist, (int)(key >> (32 - kTopBits)), cand);
    }
  }
  __syncthreads();
  const int n_local = n_stage;
  MEC_TRACE_MARK()     // the slice streamed, its candidates kept and counted

  // ---- gather the cluster's pairs and counts in block 0
  cluster.barrier_wait();          // every block of the cluster runs
  if (rank != 0) {
    if (tid == 0) push_at = atomicAdd(cluster.map_shared_rank(&n_remote, 0), n_local);
    __syncthreads();
    const int first = K - push_at - n_local;            // from the back of its buffer
    uint32_t* to_keys = cluster.map_shared_rank(keys, 0) + first;
    int* to_rbin = cluster.map_shared_rank(rbin, 0) + first;
    for (int i = tid; i < n_local; i += kThreads) {
      to_keys[i] = keys[i];
      to_rbin[i] = rbin[i];
    }
    int* to_hist = cluster.map_shared_rank(hist, 0);
    for (int i = tid; i < kTopDigits; i += kThreads) {
      const int c = hist[i];
      if (c != 0) atomicAdd(&to_hist[i], c);
    }
  }
  cluster.sync();
  MEC_TRACE_MARK()     // the cluster's pairs and counts gathered in block 0
  if (rank != 0) return;

  // ---- block 0: n pairs, at [0, n_local) and [K - n_remote, K)
  const int n_back = n_remote;
  const int n = n_local + n_back;
  const int back = K - n_back - n_local;               // pair i >= n_local sits at i + back
  if (n == 0) {
    if (tid == 0) {
      best[clip] = 0;
      has[clip] = 0;
    }
    return;
  }
  const int lo_t = (n - 1) / 2;                         // lower middle
  const int hi_t = n / 2;                               // upper middle

  // the lo_t-th smallest key (0-based): its top digit from the counts
  pick_digit<kTopDigits / kThreads>(hist, lo_t, warp_total, pick);
  uint32_t prefix = (uint32_t)pick[0] << (32 - kTopBits);
  uint32_t fixed = ~0u << (32 - kTopBits);
  int target = lo_t - pick[1];
  const int below_top = pick[1];                        // keys in the bins below
  const bool listed = pick[2] <= kShort;                // block-uniform
  MEC_TRACE_MARK()     // the top digit picked
  if (listed) {
    // that bin's keys, to the short list: a warp counts the matches in
    // its run of the keys, takes its place behind the warps below it,
    // and reads the run again to write (no atomic)
    const int run = ((n + kWarps - 1) / kWarps + 31) & ~31;
    const int w0 = min((tid >> 5) * run, n), w1 = min(w0 + run, n);
    int count = 0;
    for (int i = w0 + lane; i - lane < w1; i += 32) {
      const bool mine = i < w1 && (keys[i < n_local ? i : i + back] & fixed) == prefix;
      count += __popc(__ballot_sync(kFull, mine));
    }
    if (lane == 0) warp_total[tid >> 5] = count;
    __syncthreads();
    int at = mec::warp_sum(lane < (tid >> 5) ? warp_total[lane] : 0);
    for (int i = w0 + lane; i - lane < w1; i += 32) {
      const uint32_t key = i < w1 ? keys[i < n_local ? i : i + back] : 0u;
      const bool mine = i < w1 && (key & fixed) == prefix;
      const unsigned votes = __ballot_sync(kFull, mine);
      if (mine) shortlist[at + __popc(votes & ((1u << lane) - 1u))] = key;
      at += __popc(votes);
    }
  }
  // the keys the later rounds read: the short list, or all of them
  const int m = listed ? pick[2] : n;
  const uint32_t* from = listed ? shortlist : keys;
  const int m_front = listed ? m : n_local;
  const int m_back = listed ? 0 : back;
  MEC_TRACE_MARK()     // the short list made

  for (int shift = kLowBits; shift >= 0; shift -= kLowBits) {
    hist[tid] = 0;
    __syncthreads();             // the list is whole, the counts are 0
    for (int b0 = tid - lane; b0 < m; b0 += kThreads) {
      const int i = b0 + lane;
      const uint32_t key = i < m ? from[i < m_front ? i : i + m_back] : 0u;
      warp_hist_add(hist, (int)((key >> shift) & (kLowDigits - 1)),
                    i < m && (key & fixed) == prefix);
    }
    __syncthreads();
    pick_digit<1>(hist, target, warp_total, pick);
    prefix |= (uint32_t)pick[0] << shift;
    fixed |= (uint32_t)(kLowDigits - 1) << shift;
    target -= pick[1];
    MEC_TRACE_MARK()   // a round: digit histogram, scan, pick
  }
  const uint32_t k_lo = prefix;

  // the upper middle is k_lo itself or the next larger key
  int le = 0;
  uint32_t nxt = ~0u;
  for (int i = tid; i < m; i += kThreads) {
    const uint32_t key = from[i < m_front ? i : i + m_back];
    le += key <= k_lo;
    if (key > k_lo) nxt = min(nxt, key);
  }
  const int cnt_le = mec::block_sum(le, iscratch) + (listed ? below_top : 0);
  uint32_t k_hi = k_lo;
  if (cnt_le < hi_t + 1) {                              // block-uniform
    nxt = mec::block_min(nxt, reinterpret_cast<uint32_t*>(iscratch));
    if (nxt == ~0u) {
      // nothing larger in the listed bin: the least key of the bins above
      for (int i = tid; i < n; i += kThreads) {
        const uint32_t key = keys[i < n_local ? i : i + back];
        if (key > k_lo) nxt = min(nxt, key);
      }
      nxt = mec::block_min(nxt, reinterpret_cast<uint32_t*>(iscratch));
    }
    k_hi = nxt;
  }
  const uint32_t k_med = order_key(0.5f * (key_value(k_lo) + key_value(k_hi)));
  MEC_TRACE_MARK()     // the count at or below the lower middle, the next key

  int n_sel = 0;
  for (int i = tid; i < n; i += kThreads) {
    const int at = i < n_local ? i : i + back;
    if (keys[at] < k_med) continue;
    ++n_sel;
    const int a = rbin[at];
    if (a >= 0) atomicAdd(&bins[a], 1);
  }
  const int total_sel = mec::block_sum(n_sel, iscratch);  // barrier: bins done
  if (tid < 32) {
    // first argmax: a lane keeps the lowest of its bins on ties, and so
    // does the fold
    int top = -1, arg = 0;
    for (int j = lane; j < kBins; j += 32)
      if (bins[j] > top) {
        top = bins[j];
        arg = j;
      }
    for (int off = 16; off > 0; off >>= 1) {
      const int o_top = __shfl_xor_sync(kFull, top, off);
      const int o_arg = __shfl_xor_sync(kFull, arg, off);
      if (o_top > top || (o_top == top && o_arg < arg)) {
        top = o_top;
        arg = o_arg;
      }
    }
    if (lane == 0) {
      best[clip] = arg;
      has[clip] = total_sel > 0;
    }
  }
  MEC_TRACE_MARK()     // selection, bin histogram, argmax
}

}  // namespace

// split: blocks a clip (the cluster's size, 1 to 8). Every block holds
// room for all K slots' keys and residuals (8 bytes a slot): block 0
// gathers them, whatever share of the slots are candidates. The kernel's
// shared-memory attribute is set when a launch needs more than an
// earlier one did.
extern "C" int mec_tuning_select(const float* mags, const float* residual,
                                 const float* pitches, int batch, int K, int split,
                                 const float* edges, int* best,
                                 unsigned char* has, void* stream) {
  if (K < 1 || split < 1 || split > kMaxSplit) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int bytes = 2 * K * (int)sizeof(uint32_t);
  static mec::SmemGrant grant;
  const int granted = mec::grant_smem(tuning_select_kernel, bytes, grant);
  if (granted) return granted;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, tuning_select_kernel, mags, residual, pitches, K,
                                       edges, best, has);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
