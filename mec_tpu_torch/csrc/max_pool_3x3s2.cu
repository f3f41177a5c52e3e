// K6 max_pool_3x3s2: 3x3 / stride 2 / pad 1 max-pool of an NHWC bf16 map,
// the pool after the ResNet50 stem ReLU.
//
// Replaces: mec_tpu/ops/pallas_pool.py::max_pool_3x3s2 (kernel
// _pool_kernel). Out-of-range taps count as -inf, as in
// F.max_pool2d, so the result holds for any input sign and any H, W
// (odd sizes included): out (B, ceil(H/2), ceil(W/2), C).
//
// What bounds it on this card: bytes. At 224 px the input is
// B x 112 x 112 x 64 bf16 (51 MB at B=32) and the output a quarter of
// that; each input row is read by at most two output rows, mostly from
// L2. The TPU kernel packed bf16 sublane pairs into int32 to do the
// stride-2 column subsample without strided slices (a Mosaic
// workaround); a thread here simply reads its nine taps.
//
// Design: one thread per 8 channels of one output pixel: nine 16-byte
// loads (8 bf16 each, neighbouring threads on neighbouring channels),
// eight running maxima in f32 (bf16 -> f32 is exact), one 16-byte store.
// Taps are visited row by row, left to right, and a tap replaces the
// maximum when it is greater or NaN, the order and rule of PyTorch's
// max_pool2d, so the two are bit-exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
max_pool_3x3s2_kernel(const __nv_bfloat16* __restrict__ x, int B, int H, int W,
                      int C, int Ho, int Wo, __nv_bfloat16* __restrict__ out) {
  const int groups = C / 8;
  const long long total = (long long)B * Ho * Wo * groups;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % groups);
  long long p = idx / groups;
  const int ox = (int)(p % Wo);
  p /= Wo;
  const int oy = (int)(p % Ho);
  const int b = (int)(p / Ho);

  float m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = -INFINITY;
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = 2 * oy - 1 + dy;
    if (iy < 0 || iy >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = 2 * ox - 1 + dx;
      if (ix < 0 || ix >= W) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + (((long long)b * H + iy) * W + ix) * C + g * 8);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        if (f.x > m[2 * k] || isnan(f.x)) m[2 * k] = f.x;
        if (f.y > m[2 * k + 1] || isnan(f.y)) m[2 * k + 1] = f.y;
      }
    }
  }
  uint4 o;
  __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    oh[k] = __floats2bfloat162_rn(m[2 * k], m[2 * k + 1]);   // exact: m[] are bf16 values
  *reinterpret_cast<uint4*>(out + (((long long)b * Ho + oy) * Wo + ox) * C + g * 8) = o;
}

}  // namespace

// x: (B, H, W, C) bf16 contiguous, C % 8 == 0, 16-byte aligned (the
// wrapper checks); out: (B, Ho, Wo, C) bf16.
extern "C" int mec_max_pool_3x3s2(const void* x, int B, int H, int W, int C,
                                  void* out, void* stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long total = (long long)B * Ho * Wo * (C / 8);
  if (total == 0) return 0;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  max_pool_3x3s2_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), B, H, W, C, Ho, Wo,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
