// K3 rolloff_bins: per magnitude row, the lowest bin whose prefix sum
// reaches roll_percent of the row total; one warp per row.
//
// Replaces: mec_tpu/ops/pallas_rolloff.py::rolloff_bins_pallas (kernel
// _rolloff_kernel). An all-zero row gives bin 0 (threshold 0, prefix 0).
//
// What bounds it on this card: reading the rows, R x 1025 f32 (B x 130
// rows per batch, 17 MB at batch 32); the arithmetic is one add per bin.
// The TPU kernel ran an 11-probe binary search over VMEM-resident rows
// because its vector unit had no cheap scan; a warp has one
// (__shfl_up_sync), so the row streams through once for the total and
// once for the scan, and the scan stops at the first crossing.
//
// Design: lane l of a warp owns bins [32c + l] of chunk c. Pass 1 sums
// the row (strided per lane, then a butterfly). Pass 2 walks 32-bin
// chunks: an inclusive warp scan plus the running total of earlier
// chunks gives each lane its prefix; __ballot_sync marks the lanes at
// or past the threshold and the lowest set lane is the crossing. The
// prefix and the total are summed in different orders, so on a near-tie
// (|prefix - threshold| within rounding) the bin may differ by one from
// another summation order, as the TPU kernel's does from the cumsum
// path; if no crossing is found (possible only for non-finite input)
// the row gets the last bin, the TPU kernel's search invariant.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rolloff_bins_kernel(const float* __restrict__ mag, int R, int F,
                    float roll_percent, int* __restrict__ out) {
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;                                   // warp-uniform
  const float* row = mag + (size_t)r * F;

  float total = 0.f;
  for (int k = lane; k < F; k += 32) total += row[k];
  for (int off = 16; off > 0; off >>= 1) total += __shfl_xor_sync(0xffffffffu, total, off);
  const float thresh = roll_percent * total;

  float before = 0.f;                                   // prefix of earlier chunks
  int found = F - 1;
  for (int base = 0; base < F; base += 32) {
    const int k = base + lane;
    float v = k < F ? row[k] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, k < F && before + v >= thresh);
    if (hit) {                                          // warp-uniform
      found = base + __ffs(hit) - 1;
      break;
    }
    before += __shfl_sync(0xffffffffu, v, 31);
  }
  if (lane == 0) out[r] = found;
}

}  // namespace

extern "C" int mec_rolloff_bins(const float* mag, int R, int F, float roll_percent,
                                int* out, void* stream) {
  if (R == 0) return 0;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rolloff_bins_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      mag, R, F, roll_percent, out);
  return (int)cudaGetLastError();
}
