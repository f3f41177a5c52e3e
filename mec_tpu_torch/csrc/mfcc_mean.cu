// K1 mfcc_mean: power spectrogram -> time-averaged MFCCs, one thread
// block cluster per clip.
//
// Replaces: mec_tpu/ops/pallas_kernels.py::mfcc_mean_pallas (kernel
// _mfcc_kernel). Per clip: mel projection onto 128 Slaney mels, then
// 10*log10(max(x, 1e-10)), clamp at the clip's max over its 130 frames
// minus 80 dB, orthonormal DCT-II keeping 40 coefficients, mean over
// the 130 frames.
//
// What bounds it on this card: reading the spectrogram, 130 x 1025 f32 =
// 533 KB per clip (17 MB at batch 32). The dense mel product would be
// 17 M FMAs per clip, but the Slaney filterbank is banded: each mel row
// is nonzero only on one contiguous run of FFT bins, and the runs cover
// each bin at most twice, so the product needs ~2 K FMAs per frame, 64x
// fewer. What is left is one pass over the clip's bytes, so the kernel
// has to keep the whole card loading: many blocks, wide loads.
//
// Design: the clip's 130 frames are split over the `split` blocks of a
// cluster (the wrapper picks 10 blocks of 13 frames for a small batch:
// 10 SMs for one clip; 5 blocks of 26 frames for a large one: 160 blocks
// at batch 32, which the card holds at once, where 320 blocks in
// clusters of 10 came in two waves). A block has 13 warps, and a warp
// takes a frame from device memory to its 128 dB values on its own,
// through a buffer of its own, frame after frame, so that the warps and
// blocks of an SM drift apart and one's loads overlap another's
// arithmetic.
//  * A frame is one row of 1025 floats: it starts on any 4-byte boundary,
//    and cp.async of 16 bytes needs both addresses aligned. The warp
//    places the row in shared memory shifted by the source's own
//    misalignment, copies the aligned body wide and the few floats
//    before and after it as scalars, and waits for its own copies only.
//  * The filterbank arrives as its nonzero taps only, by bin: a bin
//    feeds at most two mels, and they are neighbours, so the bins fall
//    into 128 segments, segment s holding the bins whose lowest mel is
//    s, each bin with its weight for mel s and for mel s + 1 (exact
//    copies of the dense values; the skipped terms are exact zeros).
//    One load of a bin so feeds two FMAs. The pairs are laid out so that
//    the 32 lanes of a warp read neighbouring words at every step, and
//    sit in shared memory.
//  * Lane l walks segments l, l+32, l+64, l+96. Segment lengths grow
//    with the mel index (2 bins at the bottom, 27 at the top), so the
//    four segments of every lane add up to about the same work and
//    neighbouring lanes walk about the same length. Mel m is segment
//    m's lower sum plus segment m - 1's upper sum, which the lanes
//    exchange through the frame's dB row before they fill it.
//  * The clamp is not linear, so the clip's max must be known before the
//    time sum: every block publishes the max of its dB tile, the cluster
//    meets (cluster.sync), every block reads its peers' maxima through
//    distributed shared memory, sums its clamped frames in frame order
//    and writes the 128 partial sums into block 0's shared memory; after
//    a second cluster.sync block 0 adds them in rank order, divides by
//    130 and applies the 128 -> 40 DCT (linear, so it is applied once to
//    the mean: exact algebra, only the summation order differs from the
//    reference, DCT per frame and then the mean). No atomics: the order
//    of every sum is fixed, and two runs give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "per_device.cuh"
#include "reduce.cuh"
#include "trace.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

constexpr int kFrames = 130;
constexpr int kMels = 128;
constexpr int kMfcc = 40;
constexpr int kWarps = 13;                 // 130 = 13 * 10: a warp a frame
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 16;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// a warp's frame buffer: a frame's floats, shifted by up to 3
__host__ __device__ constexpr int row_floats(int n_bins) { return round4(n_bins + 3); }

// dynamic shared memory, in floats: a frame buffer a warp, the block's dB
// tile, the taps (pairs), and the segments (first bin, end, offset into
// the pairs: 3 x kMels ints)
__host__ __device__ constexpr int smem_floats(int frames_per, int n_bins, int n_taps) {
  return kWarps * row_floats(n_bins) + frames_per * kMels + round4(n_taps) + 3 * kMels;
}

// At the end block 0 collects the cluster's partial rows in the frame
// buffers, as many to a buffer as fit.
__host__ __device__ constexpr int partials_per_row(int n_bins) {
  return row_floats(n_bins) / kMels;
}
__device__ __forceinline__ float* partial_row(float* rows, int n_bins, int r) {
  const int per = partials_per_row(n_bins);
  return rows + (r / per) * row_floats(n_bins) + (r % per) * kMels;
}

__global__ void __launch_bounds__(kThreads)
mfcc_mean_kernel(const float* __restrict__ P, int n_bins, int frames_per,
                 const float* __restrict__ taps, int n_taps,
                 const int* __restrict__ runs,       // (3, kMels): first bin, end, offset
                 const float* __restrict__ dct,      // (kMfcc, kMels)
                 float* __restrict__ out) {          // (B, kMfcc)
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int clip = blockIdx.x / split;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) float smem[];
  __shared__ float scratch[kWarps];
  __shared__ float peer_max[kMaxSplit];             // every block's dB max, by rank
  __shared__ float mean_db[kMels];
  const int row_len = row_floats(n_bins);
  float* rows = smem;                                // (kWarps, row_len): a buffer a warp
  float* db = rows + kWarps * row_len;               // (frames_per, kMels)
  float* s_taps = db + frames_per * kMels;
  int* s_runs = reinterpret_cast<int*>(s_taps + round4(n_taps));

  MEC_TRACE_BEGIN()
  MEC_TRACE_MARK()
  // a block may write into another's shared memory once that block
  // runs: everyone says so now, and waits for the others' word only
  // where the first such write comes
  cluster.barrier_arrive();

  // ---- the tables, by all threads
  for (int i = tid; i < n_taps / 4; i += kThreads) cp_async16(s_taps + 4 * i, taps + 4 * i);
  for (int i = tid; i < 3 * kMels / 4; i += kThreads)
    cp_async16(reinterpret_cast<float*>(s_runs) + 4 * i,
               reinterpret_cast<const float*>(runs) + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Copy frame t of the block into the warp's buffer: 16-byte copies
  // where the source is aligned. Returns the frame's first float.
  const float* src0 = P + ((size_t)clip * kFrames + (size_t)rank * frames_per) * n_bins;
  float* buf = rows + warp * row_len;
  auto fetch = [&](int t) {
    const float* src = src0 + (size_t)t * n_bins;
    const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    float* row = buf + shift;                        // row[i] <-> src[i]
    const int head = min((4 - shift) & 3, n_bins);
    const int n_vec = (n_bins - head) / 4;
    for (int i = lane; i < n_vec; i += 32) cp_async16(row + head + 4 * i, src + head + 4 * i);
    if (lane < head) row[lane] = src[lane];
    for (int i = head + 4 * n_vec + lane; i < n_bins; i += 32) row[i] = src[i];
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return row;
  };
  const float* row = warp < frames_per ? fetch(warp) : buf;

  // block 0 applies the DCT at the end: its rows of the table come now,
  // off the chain (warp w takes the coefficients w, w + 13, ...)
  float d[(kMfcc + kWarps - 1) / kWarps][kMels / 32];
  if (rank == 0) {
#pragma unroll
    for (int q = 0; q < (kMfcc + kWarps - 1) / kWarps; ++q)
#pragma unroll
      for (int i = 0; i < kMels / 32; ++i) {
        const int o = warp + kWarps * q;
        d[q][i] = o < kMfcc ? dct[o * kMels + lane + 32 * i] : 0.f;
      }
  }
  // the tables are everyone's: wait for one's own part of them (the frame
  // behind it may still fly), then for the others'
  if (warp < frames_per) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  MEC_TRACE_MARK()     // copies asked for, the tables have landed

  // ---- banded mel product and dB: a warp takes the frames warp, warp +
  // 13, ... through its own buffer and waits for its own copies only
  const float2* taps2 = reinterpret_cast<const float2*>(s_taps);
  float local_max = -INFINITY;
  for (int t = warp; t < frames_per; t += kWarps) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    float lower[kMels / 32], upper[kMels / 32];
#pragma unroll
    for (int j = 0; j < kMels / 32; ++j) {
      const int seg = lane + 32 * j;
      const int first = s_runs[seg], n = s_runs[kMels + seg] - first;
      const float2* w = taps2 + s_runs[2 * kMels + seg];   // bin i of the segment at w[32 * i]
      const float* x = row + first;
      float lo = 0.f, up = 0.f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float xi = x[i];
        const float2 wi = w[32 * i];
        lo = fmaf(xi, wi.x, lo);
        up = fmaf(xi, wi.y, up);
      }
      lower[j] = lo;
      upper[j] = up;
    }
    __syncwarp();                                    // every lane is done with the frame
    // the next frame may come while the lanes trade their upper sums
    // through the dB row that they are about to fill
    if (t + kWarps < frames_per) row = fetch(t + kWarps);
    float* db_row = db + t * kMels;
#pragma unroll
    for (int j = 0; j < kMels / 32; ++j) db_row[lane + 32 * j] = upper[j];
    __syncwarp();
    float power[kMels / 32];
#pragma unroll
    for (int j = 0; j < kMels / 32; ++j) {
      const int m = lane + 32 * j;
      power[j] = m > 0 ? lower[j] + db_row[m - 1] : lower[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMels / 32; ++j) {
      const float v = 10.f * log10f(fmaxf(power[j], 1e-10f));
      db_row[lane + 32 * j] = v;
      local_max = fmaxf(local_max, v);
    }
  }
  MEC_TRACE_MARK()     // warp 0's frames: copy, mel product, dB
  const float bmax = mec::block_max(local_max, scratch);

  // ---- the clip's max: every block tells every block its own
  cluster.barrier_wait();
  if (tid < split) cluster.map_shared_rank(peer_max, tid)[rank] = bmax;
  cluster.sync();
  MEC_TRACE_MARK()     // the block's max, told to the cluster
  float clip_max = -INFINITY;
  for (int r = lane; r < split; r += 32) clip_max = fmaxf(clip_max, peer_max[r]);
  const float floor_db = mec::warp_max(clip_max) - 80.f;
  if (tid < kMels) {
    float s = 0.f;
    for (int t = 0; t < frames_per; ++t) s += fmaxf(db[t * kMels + tid], floor_db);
    partial_row(cluster.map_shared_rank(rows, 0), n_bins, rank)[tid] = s;
  }
  MEC_TRACE_MARK()     // the clamped time sums, handed to block 0
  cluster.sync();
  MEC_TRACE_MARK()
  if (rank != 0) return;

  // ---- block 0: the time mean in rank order, then the DCT
  if (tid < kMels) {
    float s = 0.f;
    for (int r = 0; r < split; ++r) s += partial_row(rows, n_bins, r)[tid];
    mean_db[tid] = s / kFrames;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < (kMfcc + kWarps - 1) / kWarps; ++q) {
    const int o = warp + kWarps * q;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMels / 32; ++i) s = fmaf(d[q][i], mean_db[lane + 32 * i], s);
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && o < kMfcc) out[clip * kMfcc + o] = s;
  }
  MEC_TRACE_MARK()     // block 0: the mean in rank order, the DCT
}

}  // namespace

// taps: the filterbank's nonzero taps as pairs (weight for mel s, for mel
// s + 1), bin i of segment s at pair offset[s] + 32 * i; runs: (3, 128)
// ints, each segment's first bin, end and offset; n_taps floats, a
// multiple of 4, both tables 16-byte aligned. split: blocks a clip (a
// divisor of 130, at most 16). The kernel's attributes are set when a
// launch needs more shared memory than an earlier one did: once or
// twice, in serving.
extern "C" int mec_mfcc_mean(const float* P, int batch, int n_frames, int n_bins,
                             const float* taps, int n_taps, const int* runs,
                             const float* dct, int split, float* out, void* stream) {
  if (n_frames != kFrames || n_bins < 1 || n_taps < 0) return (int)cudaErrorInvalidValue;
  if (split < 1 || split > kMaxSplit || kFrames % split) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(P) & 3) != 0 || n_taps % 4 != 0 ||
      ((reinterpret_cast<uintptr_t>(taps) | reinterpret_cast<uintptr_t>(runs)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const int frames_per = kFrames / split;
  const int bytes = smem_floats(frames_per, n_bins, n_taps) * (int)sizeof(float);
  if (split > kWarps * partials_per_row(n_bins)) return (int)cudaErrorInvalidValue;
  static mec::SmemGrant grant;
  const int granted = mec::grant_smem(mfcc_mean_kernel, bytes, grant, true);
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, mfcc_mean_kernel, P, n_bins, frames_per, taps,
                                       n_taps, runs, dct, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
