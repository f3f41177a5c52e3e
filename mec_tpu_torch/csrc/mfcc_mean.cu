// K1 mfcc_mean: power spectrogram -> time-averaged MFCCs, one block per clip.
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
// fewer. The kernel therefore visits only each mel's [lo, hi) run (the
// host derives the runs from the filterbank; skipped terms are exact
// zeros), and the work left is one pass over the clip's bytes.
//
// Design: one block of 512 threads per clip. Thread o computes mel
// output (t, m) = (o / 128, o % 128), so a warp covers 32 neighbouring
// mels of one frame and their bin runs overlap in L1. The 130 x 128 dB
// matrix stays in shared memory (66.5 KB, dynamic) for the block max and
// the clamp. The DCT and the time mean are linear, so the kernel
// averages the clamped dB over time first and applies the 128 -> 40 DCT
// once to the mean: exact algebra, only the summation order differs
// from the reference (DCT per frame, then the mean).
#include <cuda_runtime.h>
#include <math.h>

#include "reduce.cuh"

namespace {

constexpr int kFrames = 130;
constexpr int kMels = 128;
constexpr int kMfcc = 40;
constexpr int kThreads = 512;
constexpr int kSmemBytes = kFrames * kMels * sizeof(float);  // 66,560

__global__ void __launch_bounds__(kThreads)
mfcc_mean_kernel(const float* __restrict__ P, int n_bins,
                 const float* __restrict__ mel,      // (kMels, n_bins)
                 const int* __restrict__ mel_lo,     // (kMels,)
                 const int* __restrict__ mel_hi,     // (kMels,)
                 const float* __restrict__ dct,      // (kMfcc, kMels)
                 float* __restrict__ out) {          // (B, kMfcc)
  extern __shared__ float db[];                      // (kFrames, kMels)
  __shared__ float scratch[kThreads / 32];
  __shared__ float mean_db[kMels];
  const float* clip = P + (size_t)blockIdx.x * kFrames * n_bins;

  float local_max = -INFINITY;
  for (int o = threadIdx.x; o < kFrames * kMels; o += kThreads) {
    const int t = o / kMels, m = o % kMels;
    const float* row = clip + (size_t)t * n_bins;
    const float* w = mel + (size_t)m * n_bins;
    float acc = 0.f;
    for (int k = mel_lo[m]; k < mel_hi[m]; ++k) acc = fmaf(row[k], w[k], acc);
    const float v = 10.f * log10f(fmaxf(acc, 1e-10f));
    db[o] = v;
    local_max = fmaxf(local_max, v);
  }
  const float floor_db = mec::block_max(local_max, scratch) - 80.f;

  if (threadIdx.x < kMels) {
    float s = 0.f;
    for (int t = 0; t < kFrames; ++t) s += fmaxf(db[t * kMels + threadIdx.x], floor_db);
    mean_db[threadIdx.x] = s / kFrames;
  }
  __syncthreads();
  if (threadIdx.x < kMfcc) {
    const float* d = dct + threadIdx.x * kMels;
    float s = 0.f;
    for (int m = 0; m < kMels; ++m) s = fmaf(d[m], mean_db[m], s);
    out[blockIdx.x * kMfcc + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" int mec_mfcc_mean(const float* P, int batch, int n_frames, int n_bins,
                             const float* mel, const int* mel_lo, const int* mel_hi,
                             const float* dct, float* out, void* stream) {
  if (n_frames != kFrames) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mfcc_mean_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  mfcc_mean_kernel<<<batch, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      P, n_bins, mel, mel_lo, mel_hi, dct, out);
  return (int)cudaGetLastError();
}
