// K3 rolloff_bins: per magnitude row, the lowest bin whose prefix sum
// reaches roll_percent of the row total; one warp per row.
//
// Replaces: mec_tpu/ops/pallas_rolloff.py::rolloff_bins_pallas (kernel
// _rolloff_kernel). An all-zero row gives bin 0 (threshold 0, prefix 0).
//
// What bounds it on this card: reading the rows, R x 1025 f32 (B x 130
// rows per batch, 17 MB at batch 32); the arithmetic is one add per bin.
// So every byte should come from device memory once, in wide
// transactions, with many rows in flight, and the dependent chain
// behind the load should be short.
//
// Design.
//  * A warp brings its row into a shared-memory buffer of its own with
//    16-byte cp.async copies and waits for its own copies only: no block
//    barrier, so the warps and blocks of an SM drift apart and one's
//    load overlaps another's scan (eight warps a block, several blocks
//    an SM). A row of 1025 floats starts on any 4-byte boundary and
//    cp.async of 16 bytes needs both addresses aligned: the warp places
//    the row shifted by the source's own misalignment, copies the aligned
//    body wide and the few floats before and after it as scalars.
//  * Lane l owns the `per` = ceil(F / 32) consecutive bins from l * per
//    on (33 of 1025; a stride of 33 words is free of bank conflicts) and
//    sums them serially. One five-step warp scan of the 32 lane sums
//    gives the row total and each lane's prefix; one ballot finds the
//    first lane whose inclusive prefix reaches the threshold; that lane
//    walks its bins from its exclusive prefix to the crossing. The
//    chain is one scan and one short walk, where a scan for each 32-bin
//    chunk was up to 33 scans.
//  * The lane sums, the scan and the walk add in other orders than a
//    running sum, so on a near-tie (|prefix - threshold| within
//    rounding) the bin may differ by one from another summation order,
//    as the TPU kernel's does from the cumsum path. If the walk ends
//    below the threshold that the lane's scanned prefix reached (such a
//    tie at the lane's last bin), that last bin is the answer; if no
//    lane reaches it (possible only for non-finite input) the row gets
//    the last bin, the TPU kernel's search invariant.
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// a warp's row buffer: a row's floats, shifted by up to 3, in whole 16 bytes
__host__ __device__ constexpr int row_floats(int F) { return (F + 3 + 3) & ~3; }

__global__ void __launch_bounds__(kMaxWarps * 32)
rolloff_bins_kernel(const float* __restrict__ mag, int R, int F,
                    float roll_percent, int* __restrict__ out) {
  extern __shared__ __align__(16) float rows[];         // (warps, row_floats(F))
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= R) return;                                   // warp-uniform

  // ---- the row, into this warp's buffer: row[i] <-> src[i]
  const float* src = mag + (size_t)r * F;
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* row = rows + warp * row_floats(F) + shift;
  const int head = min((4 - shift) & 3, F);
  const int n_vec = (F - head) / 4;
  for (int i = lane; i < n_vec; i += 32) cp_async16(row + head + 4 * i, src + head + 4 * i);
  if (lane < head) row[lane] = src[lane];
  for (int i = head + 4 * n_vec + lane; i < F; i += 32) row[i] = src[i];
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // ---- lane sums, one scan
  const int per = (F + 31) / 32;
  const int lo = min(lane * per, F), hi = min(lo + per, F);
  float sum = 0.f;
#pragma unroll 8
  for (int k = lo; k < hi; ++k) sum += row[k];
  float incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  const float thresh = roll_percent * __shfl_sync(kFull, incl, 31);
  float before = __shfl_up_sync(kFull, incl, 1);        // the lanes below
  if (lane == 0) before = 0.f;

  // ---- the first lane that reaches the threshold walks to the bin
  const unsigned hit = __ballot_sync(kFull, incl >= thresh);
  int found = F - 1;
  if (hit != 0u) {                                      // warp-uniform
    const int owner = __ffs(hit) - 1;
    if (lane == owner) {
      // no early exit: the loads do not wait for the compares
      int first = F;
      float run = before;
#pragma unroll 8
      for (int k = lo; k < hi; ++k) {
        run += row[k];
        if (run >= thresh) first = min(first, k);
      }
      found = first < F ? first : hi - 1;
    }
    found = __shfl_sync(kFull, found, owner);
  }
  if (lane == 0) out[r] = found;
}

}  // namespace

// warps: rows a block (1 to 8), a warp each; the wrapper takes fewer for
// few rows, so that they spread over the SMs.
extern "C" int mec_rolloff_bins(const float* mag, int R, int F, float roll_percent,
                                int warps, int* out, void* stream) {
  if (F < 1 || warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(mag) & 3) != 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int bytes = warps * row_floats(F) * (int)sizeof(float);
  static mec::SmemGrant grant(48 * 1024);               // what a launch gets unasked
  const int granted = mec::grant_smem(rolloff_bins_kernel, bytes, grant);
  if (granted) return granted;
  const int blocks = (R + warps - 1) / warps;
  rolloff_bins_kernel<<<blocks, warps * 32, bytes, (cudaStream_t)stream>>>(
      mag, R, F, roll_percent, out);
  return (int)cudaGetLastError();
}
