// K5 dft_power: windowed frames -> power and magnitude spectrograms.
//
// Replaces: mec_tpu/ops/pallas_kernels.py::dft_spectrograms (kernel
// _make_dft_power_kernel). For frames A (M, K = 2048) and the DFT bases
// C, S (K, N = 1025), C[n][k] = cos(2 pi n k / K), S[n][k] = -sin(...):
//   re = A @ C, im = A @ S, P = re*re + im*im, mag = sqrt(P),
// both written as (M, N) fp32. Two precisions (template parameter):
//   highest: fp32 operands and fp32 FMAs (no TF32);
//   bf16:    the frames are rounded to bf16 (RNE) as they enter shared
//            memory, the bases arrive already rounded (the wrapper rounds
//            them once), and the products (exact in fp32) are summed in
//            fp32 -- the TPU kernel's one-pass DEFAULT precision.
//
// What bounds it on this card: arithmetic. At B = 32 (M = 4160) the
// two products are 4 M K N = 34.9 GFLOP against ~85 MB of traffic, so
// the 67 TFLOP/s fp32 CUDA-core rate (H100 SXM data sheet) sets the
// floor at 0.52 ms; the tensor cores' TF32 would break the 'highest'
// contract.
//
// Design: a shared-memory tiled GEMM that computes the same (128 rows x
// 64 bins) tile against BOTH bases, so re and im of a bin meet in
// registers and the P/mag epilogue never leaves them (as the TPU
// kernel's body does). 256 threads, one block per SM; thread (ty, tx)
// owns rows ty*8 .. ty*8+7 and bins tx*4 .. tx*4+3 of the tile, 64
// accumulators.
// K advances 16 at a time through double-buffered shared memory (one
// barrier per step); the next step's tile is fetched into registers
// while the current one is consumed. The odd N = 1025 and a ragged M are
// handled at the tile edge: out-of-range loads read zeros, out-of-range
// outputs are not stored (the TPU's padding to 1152 bins and 128-row
// tiles was a Mosaic limit and is not carried over).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;  // rows (frames) per tile
constexpr int kBN = 64;   // bins per tile
constexpr int kBK = 16;   // contraction step
constexpr int kTM = 8;    // rows per thread
constexpr int kTN = 4;    // bins per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Launch bounds ask for one block per SM, so the register allocator may
// go past 128: the 64 accumulators, the fragments and the prefetch take
// ~150 registers, and a cap of 128 (two blocks per SM) spilled them to
// local memory and ran 1.5x slower.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
dft_power_kernel(const float* __restrict__ frames,  // (M, K)
                 const float* __restrict__ cosb,    // (K, N)
                 const float* __restrict__ sinb,    // (K, N)
                 int M, int K, int N,
                 float* __restrict__ P,             // (M, N)
                 float* __restrict__ mag) {         // (M, N)
  __shared__ __align__(16) float As[2][kBK][kBM];   // frames, k-major
  __shared__ __align__(16) float Cs[2][kBK][kBN];
  __shared__ __align__(16) float Ss[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN), ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // A tile: 128 rows x 16 floats = 512 float4, two per thread
  float4 a_reg[2];
  // basis tiles: 16 x 64 = 1024 floats each, four per thread
  float c_reg[4], s_reg[4];

  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = tid + kThreads * e, r = f / 4, c4 = f % 4;
      a_reg[e] = (m0 + r < M)
          ? *reinterpret_cast<const float4*>(frames + (size_t)(m0 + r) * K + k0 + c4 * 4)
          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + kThreads * e, k = idx / kBN, n = n0 + idx % kBN;
      const size_t off = (size_t)(k0 + k) * N + n;
      c_reg[e] = n < N ? cosb[off] : 0.f;
      s_reg[e] = n < N ? sinb[off] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int f = tid + kThreads * e, r = f / 4, c = (f % 4) * 4;
      As[buf][c + 0][r] = operand<kBf16>(a_reg[e].x);
      As[buf][c + 1][r] = operand<kBf16>(a_reg[e].y);
      As[buf][c + 2][r] = operand<kBf16>(a_reg[e].z);
      As[buf][c + 3][r] = operand<kBf16>(a_reg[e].w);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + kThreads * e, k = idx / kBN, n = idx % kBN;
      Cs[buf][k][n] = c_reg[e];
      Ss[buf][k][n] = s_reg[e];
    }
  };

  float re[kTM][kTN], im[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) re[i][j] = im[i][j] = 0.f;

  const int steps = K / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[buf][k][ty * kTM]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[buf][k][ty * kTM + 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Cs[buf][k][tx * kTN]);
      const float4 sn = *reinterpret_cast<const float4*>(&Ss[buf][k][tx * kTN]);
      const float a[kTM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float cv[kTN] = {c.x, c.y, c.z, c.w};
      const float sv[kTN] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          re[i][j] = fmaf(a[i], cv[j], re[i][j]);
          im[i][j] = fmaf(a[i], sv[j], im[i][j]);
        }
    }
    // the other buffer was last read in step s - 1, before the barrier
    // that ended it, so it can be refilled now
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

  // P = re*re + im*im rounded as the plain version rounds it (no FMA
  // contraction), mag = sqrt(P) correctly rounded
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= M) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < N) {
        const float p = __fadd_rn(__fmul_rn(re[i][j], re[i][j]),
                                  __fmul_rn(im[i][j], im[i][j]));
        P[(size_t)m * N + n] = p;
        mag[(size_t)m * N + n] = __fsqrt_rn(p);
      }
    }
  }
}

}  // namespace

extern "C" int mec_dft_power(const float* frames, const float* cosb, const float* sinb,
                             int M, int K, int N, int bf16, float* P, float* mag,
                             void* stream) {
  // float4 frame loads need K % 4 == 0 (16-byte rows; the wrapper checks
  // the base pointer) and the K loop whole 16-wide steps
  if (K <= 0 || K % kBK != 0 || N <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (bf16)
    dft_power_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        frames, cosb, sinb, M, K, N, P, mag);
  else
    dft_power_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        frames, cosb, sinb, M, K, N, P, mag);
  return (int)cudaGetLastError();
}
