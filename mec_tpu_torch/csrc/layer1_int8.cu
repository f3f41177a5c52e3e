// K7 layer1_int8: ResNet50 layer1 (three bottleneck blocks, ten int8
// convs) in QuantConv static numerics, on NHWC maps of any H and W.
//
// Replaces: mec_tpu/ops/pallas_resnet.py::layer1_pallas (kernel
// _layer1_kernel). Input (B, H, W, 64) bf16 (the pooled stem), output
// (B, H, W, 256) bf16; weights (Cout, kh*kw*Cin) int8 with Cin fastest,
// per-channel f32 kernel scales and biases, and the ten calibrated
// activation scales in device memory, in the TPU kernel's _CONV_ORDER.
//
// Numerics, op for op the port's QuantConv static path (models/qconv.py)
// and so the JAX module's:
//   quantize   q = clip(rint(x / s_x), -127, 127), a true division
//              (__fdiv_rn), half to even; block 0 quantizes its input
//              twice, with conv1's and the downsample's own scales
//   conv       s8 x s8 -> s32, exact (__dp4a)
//   epilogue   f = acc * (s_x * s_c[c]) + b[c], each step rounded
//              (__fmul_rn, __fadd_rn: no FMA contraction), then bf16
//              (round to nearest even), then ReLU
//   residual   relu(bf16(out + identity)), the add in f32 on bf16
//              operands
// The port's plain version runs the same steps in eager PyTorch (one
// rounding per op, im2col + cuBLASLt int8 GEMMs), so the two are
// bit-exact. (The TPU kernel multiplied by a reciprocal scale instead of
// dividing, which moves a value by one int8 step on .5 ties; the engine
// it stands in for divides, and so does this kernel.)
//
// What bounds it on this card: the int8 math. Layer1 is ~213 K MACs per
// output pixel (21 G MACs at B=32, 224 px). __dp4a runs on the CUDA
// cores, about 1/16 of the int8 tensor-core rate, so this kernel is
// compute-bound and slower than cuBLASLt's int8 GEMMs at large batch;
// it keeps every intermediate in int8 (the quantize of the next conv is
// fused into each epilogue) and never materialises im2col (9x the 3x3
// input). Tensor-core MMA (mma.sync/wgmma s8) and keeping the residual
// stream on chip across blocks are the next steps.
//
// Design: one implicit-GEMM launch per conv (plus one quantize launch
// for the block-0 input): rows are output pixels, columns output
// channels, K = kh*kw*Cin in 64-byte chunks (a chunk never straddles a
// 3x3 tap because Cin % 64 == 0). A block computes a 32-pixel x
// 64-channel tile with 128 threads, each a 4x4 register tile; per chunk
// the block stages 32x64 activation bytes (zero for taps outside the
// image) and 64x64 weight bytes in shared memory as 32-bit words,
// transposed so each thread reads its four pixels' and four channels'
// words with one 16-byte load each.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTP = 32;     // output pixels per block
constexpr int kTC = 64;     // output channels per block
constexpr int kKC = 64;     // K bytes per chunk
constexpr int kKW = kKC / 4;
constexpr int kThreads = 128;

__device__ __forceinline__ int8_t quantize(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.f), 127.f);
  return (int8_t)q;
}

// x (n8 groups of 8 bf16) -> q0 with scales[i0], q1 with scales[i1]
__global__ void __launch_bounds__(256)
quantize2_kernel(const __nv_bfloat16* __restrict__ x, long long n8,
                 const float* __restrict__ scales, int i0, int i1,
                 int8_t* __restrict__ q0, int8_t* __restrict__ q1) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  const float s0 = scales[i0], s1 = scales[i1];
  const uint4 v = reinterpret_cast<const uint4*>(x)[i];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  union { int8_t b[8]; uint2 u; } a, c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    a.b[2 * k] = quantize(f.x, s0);
    a.b[2 * k + 1] = quantize(f.y, s0);
    c.b[2 * k] = quantize(f.x, s1);
    c.b[2 * k + 1] = quantize(f.y, s1);
  }
  reinterpret_cast<uint2*>(q0)[i] = a.u;
  reinterpret_cast<uint2*>(q1)[i] = c.u;
}

struct ConvArgs {
  const int8_t* xq;        // (B, H, W, Cin) int8
  const int8_t* wq;        // (Cout, ks*ks*Cin) int8
  const float* kscale;     // (Cout,)
  const float* bias;       // (Cout,)
  const float* scales;     // the ten activation scales
  const __nv_bfloat16* residual;  // (M, Cout) bf16 or null
  __nv_bfloat16* out;      // (M, Cout) bf16 or null
  int8_t* outq;            // (M, Cout) int8 or null
  int B, H, W, Cin, Cout, ks;
  int s_idx;               // this conv's activation scale
  int q_idx;               // the next conv's scale (outq)
  int relu;
};

__global__ void __launch_bounds__(kThreads)
conv_int8_kernel(const ConvArgs a) {
  __shared__ __align__(16) int As[kKW][kTP];
  __shared__ __align__(16) int Bs[kKW][kTC];
  const int HW = a.H * a.W;
  const int M = a.B * HW;
  const int K = a.ks * a.ks * a.Cin;
  const int m0 = blockIdx.x * kTP;
  const int c0 = blockIdx.y * kTC;
  const int t = threadIdx.x;
  const int cg = t & 15, pg = t >> 4;   // 16 channel groups x 8 pixel groups

  // activation loader: pixel t/4, 16-byte piece t%4 of the chunk
  const int lp = t >> 2, piece = t & 3;
  const int lm = m0 + lp;
  const bool lvalid = lm < M;
  int lb = 0, ly = 0, lx = 0;
  if (lvalid) {
    lb = lm / HW;
    const int r = lm - lb * HW;
    ly = r / a.W;
    lx = r - ly * a.W;
  }

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int tap = k0 / a.Cin, ci = k0 - tap * a.Cin;
    const int dy = a.ks == 3 ? tap / 3 - 1 : 0;
    const int dx = a.ks == 3 ? tap % 3 - 1 : 0;
    const int iy = ly + dy, ix = lx + dx;
    int4 v = make_int4(0, 0, 0, 0);
    if (lvalid && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
      v = *reinterpret_cast<const int4*>(
          a.xq + (((long long)lb * a.H + iy) * a.W + ix) * a.Cin + ci + piece * 16);
    As[piece * 4 + 0][lp] = v.x;
    As[piece * 4 + 1][lp] = v.y;
    As[piece * 4 + 2][lp] = v.z;
    As[piece * 4 + 3][lp] = v.w;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = t + r * kThreads;      // 0..255: channel idx/4, piece idx%4
      const int c = idx >> 2, wp = idx & 3;
      const int4 w = *reinterpret_cast<const int4*>(
          a.wq + (long long)(c0 + c) * K + k0 + wp * 16);
      Bs[wp * 4 + 0][c] = w.x;
      Bs[wp * 4 + 1][c] = w.y;
      Bs[wp * 4 + 2][c] = w.z;
      Bs[wp * 4 + 3][c] = w.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kKW; ++k) {
      const int4 x4 = *reinterpret_cast<const int4*>(&As[k][pg * 4]);
      const int4 w4 = *reinterpret_cast<const int4*>(&Bs[k][cg * 4]);
      const int xs[4] = {x4.x, x4.y, x4.z, x4.w};
      const int ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xs[i], ws[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: dequant + bias, bf16, residual, ReLU, next quantize
  const float sx = a.scales[a.s_idx];
  const float qs = a.q_idx >= 0 ? a.scales[a.q_idx] : 1.f;
  const int cb = c0 + cg * 4;
  float mul[4], bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mul[j] = __fmul_rn(sx, a.kscale[cb + j]);
    bias[j] = a.bias[cb + j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + pg * 4 + i;
    if (m >= M) continue;
    const long long off = (long long)m * a.Cout + cb;
    float res[4] = {0.f, 0.f, 0.f, 0.f};
    if (a.residual) {
      const uint2 r = *reinterpret_cast<const uint2*>(a.residual + off);
      const __nv_bfloat162* rh = reinterpret_cast<const __nv_bfloat162*>(&r);
      const float2 r0 = __bfloat1622float2(rh[0]), r1 = __bfloat1622float2(rh[1]);
      res[0] = r0.x; res[1] = r0.y; res[2] = r1.x; res[3] = r1.y;
    }
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float f = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), mul[j]), bias[j]);
      float v = __bfloat162float(__float2bfloat16_rn(f));
      if (a.residual) v = __bfloat162float(__float2bfloat16_rn(__fadd_rn(v, res[j])));
      if (a.relu && v < 0.f) v = 0.f;
      y[j] = v;                               // a bf16 value, held in f32
    }
    if (a.out) {
      uint2 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
      oh[0] = __floats2bfloat162_rn(y[0], y[1]);
      oh[1] = __floats2bfloat162_rn(y[2], y[3]);
      *reinterpret_cast<uint2*>(a.out + off) = o;
    }
    if (a.outq) {
      union { int8_t b[4]; int u; } q;
#pragma unroll
      for (int j = 0; j < 4; ++j) q.b[j] = quantize(y[j], qs);
      *reinterpret_cast<int*>(a.outq + off) = q.u;
    }
  }
}

int launch_conv(const ConvArgs& a, cudaStream_t stream) {
  const long long M = (long long)a.B * a.H * a.W;
  const dim3 grid((unsigned)((M + kTP - 1) / kTP), a.Cout / kTC);
  conv_int8_kernel<<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, 64) bf16. wq/kscale/bias: ten device pointers each, in
// _CONV_ORDER (b0 conv1, conv2, conv3, downsample; b1 conv1..3; b2
// conv1..3). scales: ten f32 on the device. Scratch: qa, qd, h1q, h2q
// (M x 64 int8), resq (M x 256 int8), ident (M x 256 bf16). out:
// (B, H, W, 256) bf16, which also carries the residual stream (each
// element is read and written by one thread). Shapes and alignment are
// checked by the wrapper (ops/resnet_kernel.py).
extern "C" int mec_layer1_int8(const void* x, int B, int H, int W,
                               const void* const* wq, const float* const* kscale,
                               const float* const* bias, const float* scales,
                               void* qa, void* qd, void* h1q, void* h2q, void* resq,
                               void* ident, void* out, void* stream) {
  const long long M = (long long)B * H * W;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n8 = M * 64 / 8;
  quantize2_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), n8, scales, 0, 3,
      static_cast<int8_t*>(qa), static_cast<int8_t*>(qd));
  int err = (int)cudaGetLastError();
  if (err) return err;

  auto conv = [&](int i, const void* in, int cin, int cout, int ks, int relu,
                  const void* residual, void* o, void* oq, int q_idx) {
    ConvArgs a;
    a.xq = static_cast<const int8_t*>(in);
    a.wq = static_cast<const int8_t*>(wq[i]);
    a.kscale = kscale[i];
    a.bias = bias[i];
    a.scales = scales;
    a.residual = static_cast<const __nv_bfloat16*>(residual);
    a.out = static_cast<__nv_bfloat16*>(o);
    a.outq = static_cast<int8_t*>(oq);
    a.B = B; a.H = H; a.W = W; a.Cin = cin; a.Cout = cout; a.ks = ks;
    a.s_idx = i; a.q_idx = q_idx; a.relu = relu;
    return launch_conv(a, s);
  };
  // block 0: identity = downsample(x)
  if ((err = conv(0, qa, 64, 64, 1, 1, nullptr, nullptr, h1q, 1))) return err;
  if ((err = conv(1, h1q, 64, 64, 3, 1, nullptr, nullptr, h2q, 2))) return err;
  if ((err = conv(3, qd, 64, 256, 1, 0, nullptr, ident, nullptr, -1))) return err;
  if ((err = conv(2, h2q, 64, 256, 1, 1, ident, out, resq, 4))) return err;
  // blocks 1 and 2: identity = the residual stream in `out`
  for (int blk = 0; blk < 2; ++blk) {
    const int o = 4 + 3 * blk;
    const int next = blk == 0 ? 7 : -1;
    if ((err = conv(o, resq, 256, 64, 1, 1, nullptr, nullptr, h1q, o + 1))) return err;
    if ((err = conv(o + 1, h1q, 64, 64, 3, 1, nullptr, nullptr, h2q, o + 2))) return err;
    if ((err = conv(o + 2, h2q, 64, 256, 1, 1, out, out, next >= 0 ? resq : nullptr, next)))
      return err;
  }
  return 0;
}
