// K2 tuning_select: the selection phase of librosa.estimate_tuning, one
// block per clip row of K pitch candidates.
//
// Replaces: mec_tpu/ops/pallas_tuning.py::tuning_select_pallas (kernel
// _tuning_kernel). Per row: the masked median of the candidate
// magnitudes (mask = pitch > 0), sel = mags >= median & mask, a 100-bin
// histogram of the selected residuals against the 101 ceil-to-f32 edges
// of audio_features._hist_edges_ceil32, the first argmax, and whether
// anything was selected.
//
// What bounds it on this card: not bytes (3 x 93 KB per row at the
// serving K = 23,270) but the 34 dependent passes over the row that an
// exact median needs: 32 binary-search probes, each a count of
// key <= mid over K elements and a block-wide sum, then two more
// passes for the upper middle. Every pass must finish before the next
// probe is known.
//
// Design: the row's order keys live in shared memory (K x 4 B, dynamic),
// so the 34 passes read shared memory instead of device memory. The
// median searches the uint32 order-preserving key space of
// audio_features._kth_smallest (negative floats -> ~bits, others ->
// bits | 0x80000000): CUDA has unsigned compares, so the TPU kernel's
// signed-key workaround is not needed. Counts are integers, so the
// block sums are exact and the result is bit-identical to the reference
// whatever the summation order. The histogram bins each selected
// residual by binary search over the same 101 f32 edges (f32 compares,
// as the reference's count-differencing does) with shared-memory
// integer atomics: deterministic. Ties in the argmax go to the lowest
// bin, as np.argmax does.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kBins = 100;

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

__global__ void __launch_bounds__(kThreads)
tuning_select_kernel(const float* __restrict__ mags,
                     const float* __restrict__ residual,
                     const float* __restrict__ pitches, int K,
                     const float* __restrict__ edges,   // (kBins + 1,)
                     int* __restrict__ best, unsigned char* __restrict__ has) {
  extern __shared__ uint32_t keys[];                    // (K,)
  __shared__ int iscratch[kThreads / 32];
  __shared__ float fscratch[kThreads / 32];
  __shared__ float edge[kBins + 1];
  __shared__ int hist[kBins];

  const size_t row = (size_t)blockIdx.x * K;
  const float big = FLT_MAX;
  for (int i = threadIdx.x; i <= kBins; i += kThreads) edge[i] = edges[i];
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;

  int n_cand = 0;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const bool cand = pitches[row + i] > 0.f;
    keys[i] = order_key(cand ? mags[row + i] : big);
    n_cand += cand;
  }
  const int kcnt = mec::block_sum(n_cand, iscratch);   // barrier: keys ready
  const int lo_t = max((kcnt - 1) / 2, 0);             // lower middle
  const int hi_t = max(kcnt / 2, 0);                   // upper middle

  // smallest key whose count of keys <= it exceeds lo_t
  uint32_t lo = 0u, hi = 0xFFFFFFFFu;
  for (int pass = 0; pass < 32; ++pass) {
    const uint32_t mid = lo + (hi - lo) / 2u;
    int c = 0;
    for (int i = threadIdx.x; i < K; i += kThreads) c += keys[i] <= mid;
    if (mec::block_sum(c, iscratch) >= lo_t + 1) hi = mid; else lo = mid + 1u;
  }
  const float v_lo = key_value(lo);

  // the upper middle is v_lo itself or the next larger value
  int le = 0;
  float nxt = big;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float f = key_value(keys[i]);
    le += f <= v_lo;
    if (f > v_lo) nxt = fminf(nxt, f);
  }
  const int cnt_le = mec::block_sum(le, iscratch);
  nxt = mec::block_min(nxt, fscratch);
  const float v_hi = (cnt_le >= hi_t + 1) ? v_lo : nxt;
  const float med = kcnt > 0 ? 0.5f * (v_lo + v_hi) : 0.f;

  int n_sel = 0;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    if (!(pitches[row + i] > 0.f && mags[row + i] >= med)) continue;
    ++n_sel;
    const float r = residual[row + i];
    // bin j counts edge[j] <= r < edge[j+1]; r outside [edge[0],
    // edge[kBins]) or NaN falls in no bin, as in the reference
    if (!(r >= edge[0]) || r >= edge[kBins]) continue;
    int a = 0, b = kBins - 1;                          // largest j: edge[j] <= r
    while (a < b) {
      const int m = (a + b + 1) / 2;
      if (r >= edge[m]) a = m; else b = m - 1;
    }
    atomicAdd(&hist[a], 1);
  }
  const int total_sel = mec::block_sum(n_sel, iscratch);  // barrier: hist done
  if (threadIdx.x == 0) {
    int arg = 0;
    for (int j = 1; j < kBins; ++j)
      if (hist[j] > hist[arg]) arg = j;
    best[blockIdx.x] = arg;
    has[blockIdx.x] = total_sel > 0;
  }
}

}  // namespace

extern "C" int mec_tuning_select(const float* mags, const float* residual,
                                 const float* pitches, int batch, int K,
                                 const float* edges, int* best,
                                 unsigned char* has, void* stream) {
  if (batch == 0) return 0;
  const int smem = K * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      tuning_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  tuning_select_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      mags, residual, pitches, K, edges, best, has);
  return (int)cudaGetLastError();
}
