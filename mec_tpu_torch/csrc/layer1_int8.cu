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
//   quantize   q = clip(rint(x / s_x), -127, 127), the quotient
//              correctly rounded, half to even (see `quantize` below);
//              block 0 quantizes its input twice, with conv1's and the
//              downsample's own scales
//   conv       s8 x s8 -> s32 on the tensor cores; integer sums are
//              exact in any order
//   epilogue   f = acc * (s_x * s_c[c]) + b[c], each step rounded
//              (__fmul_rn, __fadd_rn: no FMA contraction), then bf16
//              (round to nearest even), then ReLU
//   residual   relu(bf16(out + identity)), the add in f32 on bf16
//              operands
// The port's plain version runs the same steps in eager PyTorch (one
// rounding per op, im2col + cuBLASLt int8 GEMMs), so the two are
// bit-exact. (The TPU kernel multiplied by a reciprocal scale instead of
// dividing, which moves a value by one int8 step on .5 ties; the engine
// it stands in for divides, and this kernel's quotients equal a
// division's.)
//
// What bounds it on this card (H100 SXM data sheet). Layer1 is ~213 K
// MACs per output pixel, 42.7 GOP at B = 32 and 224 px: 0.022 ms at the
// int8 tensor-core rate, next to 0.019 ms for its own input, output and
// weights (64 MB). The layer cannot be one pass, though: a 3x3 conv
// needs its neighbours' rows, so the 64-channel int8 maps and the bf16
// residual stream go through device memory between launches (~360 MB at
// B = 32, ~0.11 ms at the memory rate). With the MACs on the tensor
// cores, what is left is streaming plus the per-element epilogues (a
// dequant and a quantize per value, ~250 M values at B = 32), so the
// design is about bytes, latency and cheap epilogues, not about math.
//
// Design: seven launches of three kernels, all implicit GEMMs on
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (rows are pixels,
// columns output channels; activations with Cin fastest and weights
// (Cout, K) are the row.col form as they lie). mma.sync, not wgmma: the
// math is a tenth of the time at either rate, and mma.sync's fragments
// are filled by ldmatrix, whose per-lane row addresses are what the 3x3
// conv below needs.
// * conv1x1_in (block 0's conv1): 128 pixels x 64 channels a block; the
//   bf16 input is quantized in the loader.
// * conv3x3: 128 pixels x 64 channels a block. The block copies its
//   pixels plus a halo of W + 1 pixels on either side (cp.async, 16
//   bytes a copy, zero-fill outside the map) and all nine taps' weights
//   into shared memory once; tap (dy, dx) of a pixel is then the tile row
//   dy * W + dx further on, which each lane hands to ldmatrix as its own
//   row address, or a row of zeros where the tap leaves the image. The
//   input is read once, not nine times.
// * conv256 (conv3 of each block): 64 pixels x all 256 channels a block
//   (64, not 128: with the weights of up to three convs resident, 64
//   pixels keep two to three blocks on an SM), in two passes of 128
//   channels. In block 0 the same launch computes the downsample conv on
//   the bf16 input (quantized in the loader with its own scale), so the
//   identity map never leaves the chip. The residual of blocks 1 and 2
//   is the output tensor itself: each 16-byte piece is read and
//   rewritten by one thread of the block that owns its pixel (a 1x1 conv
//   reads no neighbour's residual). In blocks 0 and 1 the quantized
//   output tile stays in shared memory and the launch goes on to run the
//   next block's conv1 (256 -> 64) on it, so that int8 map is never
//   written either.
// * Every epilogue (dequant, bias, bf16, ReLU, the next conv's quantize)
//   stages its tile in shared memory so that each thread stores 16
//   bytes. Shared-memory rows are 64 data bytes padded to 80, which makes
//   every ldmatrix conflict-free.
// * Small batches: at B = 1 (3,136 pixels) 128-pixel tiles would give 25
//   blocks, so the wrapper picks 16-pixel tiles (196 blocks of 4 warps).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;   // K bytes per chunk
constexpr int kLd = 80;      // shared-memory bytes per row of a chunk
constexpr int kLdStage = 128 + 8;   // bf16 per row of a staged 128-channel tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An activation scale and its reciprocal.
struct Quant {
  float s, r;
};
__device__ __forceinline__ Quant make_quant(const float* s) {
  Quant q;
  q.s = *s;
  q.r = __frcp_rn(q.s);
  return q;
}

// clip(rint(v / s), -127, 127) with the quotient of a true division.
// t = v * (1/s) is within |t| * 2^-22 of the correctly rounded quotient,
// so unless t lies within 1e-3 of a tie (n + 0.5) both round to the same
// integer (|t| < 4194 keeps the error under 1e-3; beyond that both clip
// to +-127); near a tie the division itself decides. Values are bf16 and
// quotients small, so ties are rare and the division is off the common
// path: it costs ~30 instructions a value, several times the rest of an
// epilogue.
__device__ __forceinline__ int8_t quantize(float v, Quant q) {
  const float t = __fmul_rn(v, q.r);
  float r = rintf(t);
  if (fabsf(t - r) > 0.499f) r = rintf(__fdiv_rn(v, q.s));   // |t - r| <= 0.5
  return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the conv's epilogue up to the first bf16 rounding
__device__ __forceinline__ float dequant(int acc, float mul, float bias) {
  return round_bf16(__fadd_rn(__fmul_rn(__int2float_rn(acc), mul), bias));
}

// 8 bf16 (16 bytes) -> 8 int8 (8 bytes)
__device__ __forceinline__ uint2 quantize8(uint4 v, Quant s) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  union { int8_t b[8]; uint2 u; } q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    q.b[2 * k] = quantize(f.x, s);
    q.b[2 * k + 1] = quantize(f.y, s);
  }
  return q.u;
}

// A tile of bf16 pixels (rows of 64 channels) quantized into a chunk
// tile: rows past M are zero.
template <int BM, int kThreads>
__device__ __forceinline__ void load_quantized(unsigned char* As, const __nv_bfloat16* x,
                                               long long M, long long m0, Quant s, int tid) {
  constexpr int kPieces = (BM * 8 + kThreads - 1) / kThreads;
  uint4 v[kPieces];
#pragma unroll
  for (int e = 0; e < kPieces; ++e) {
    const int f = tid + e * kThreads, r = f >> 3, c = f & 7;
    v[e] = make_uint4(0u, 0u, 0u, 0u);     // bf16 zeros quantize to zeros
    if (f < BM * 8 && m0 + r < M)
      v[e] = *reinterpret_cast<const uint4*>(x + (m0 + r) * 64 + c * 8);
  }
#pragma unroll
  for (int e = 0; e < kPieces; ++e) {
    const int f = tid + e * kThreads, r = f >> 3, c = f & 7;
    if (f < BM * 8) *reinterpret_cast<uint2*>(As + r * kLd + c * 8) = quantize8(v[e], s);
  }
}

// One 64-byte K chunk: acc[i][j] += A x W^T. arow[i]: this lane's row of
// the warp's i-th 16-pixel fragment (row lane & 15 of it), 64 bytes;
// w0: the warp's first channel row of a weight tile with kLd-byte rows.
template <int MT, int NT>
__device__ __forceinline__ void mma_chunk(int (&acc)[MT][NT][4],
                                          const unsigned char* const (&arow)[MT],
                                          const unsigned char* w0, int lane) {
  static_assert(NT % 2 == 0, "channel fragments come in pairs");
#pragma unroll
  for (int ks = 0; ks < kChunk; ks += 32) {
    // A: lanes 0-15 give rows 0-15 at bytes ks .. ks+15, lanes 16-31 the
    // same rows at bytes ks+16 .. ks+31
    uint32_t a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], arow[i] + ks + (lane >> 4) * 16);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      // W: two 8-channel fragments a load; lanes 0-7 and 8-15 the two
      // 16-byte halves of channels 0-7, lanes 16-31 of channels 8-15
      uint32_t b[4];
      ldmatrix_x4(b, w0 + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + ks +
                         ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_s8(acc[i][2 * jp], a[i], b[0], b[1]);
        mma_s8(acc[i][2 * jp + 1], a[i], b[2], b[3]);
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void clear(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// The epilogue of a conv with 64 output channels: dequant, bias, bf16,
// ReLU, the next conv's quantize, staged as an int8 tile (BM rows of kLd
// bytes at `tile`, which no warp reads any more), then 16 bytes a thread
// to outq (M, 64). A fragment holds rows g and g + 8, channels 2t, 2t+1.
template <int BM, int MT, int NT, int kThreads>
__device__ __forceinline__ void store_int8_tile(int (&acc)[MT][NT][4], unsigned char* tile,
                                                int rb, int nb, float sx,
                                                const float* kscale, const float* bias,
                                                Quant sq, int8_t* outq, long long M,
                                                long long m0, int tid) {
  const int g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = nb + j * 8 + 2 * t;
    const float mul0 = __fmul_rn(sx, kscale[c]), mul1 = __fmul_rn(sx, kscale[c + 1]);
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        char2 q;
        q.x = quantize(fmaxf(dequant(acc[i][j][2 * h], mul0, b0), 0.f), sq);
        q.y = quantize(fmaxf(dequant(acc[i][j][2 * h + 1], mul1, b1), 0.f), sq);
        *reinterpret_cast<char2*>(tile + (rb + i * 16 + g + 8 * h) * kLd + c) = q;
      }
  }
  __syncthreads();
  for (int f = tid; f < BM * 4; f += kThreads) {
    const long long m = m0 + (f >> 2);
    if (m < M)
      *reinterpret_cast<uint4*>(outq + m * 64 + (f & 3) * 16) =
          *reinterpret_cast<const uint4*>(tile + (f >> 2) * kLd + (f & 3) * 16);
  }
}

struct Conv64Args {
  const void* x;           // (M, 64): bf16 (conv1x1_in) or int8 (conv3x3)
  const int8_t* w;         // (64, K)
  const float* kscale;     // (64,)
  const float* bias;       // (64,)
  const float* sx;         // this conv's activation scale
  const float* sq;         // the next conv's
  int8_t* outq;            // (M, 64)
  int B, H, W;
};

// ----------------------------------------------------------------------
// conv1x1_in: block 0's conv1, 64 -> 64 channels, from the bf16 input
// ----------------------------------------------------------------------
template <int BM, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
conv1x1_in_kernel(const Conv64Args a) {
  constexpr int kThreads = 32 * WM * WN;
  constexpr int MT = BM / (16 * WM), NT = 64 / (8 * WN);
  __shared__ __align__(16) unsigned char smem[(BM + 64) * kLd];
  unsigned char* As = smem;
  unsigned char* Ws = smem + BM * kLd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = (warp % WM) * MT * 16, nb = (warp / WM) * NT * 8;
  const long long M = (long long)a.B * a.H * a.W;
  const long long m0 = (long long)blockIdx.x * BM;

  for (int f = tid; f < 64 * 4; f += kThreads)
    cp_async16(Ws + (f >> 2) * kLd + (f & 3) * 16, a.w + (f >> 2) * 64 + (f & 3) * 16, true);
  const Quant sx = make_quant(a.sx);
  load_quantized<BM, kThreads>(As, static_cast<const __nv_bfloat16*>(a.x), M, m0, sx, tid);
  cp_async_wait_all();
  __syncthreads();

  int acc[MT][NT][4];
  clear(acc);
  const unsigned char* arow[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) arow[i] = As + (rb + i * 16 + (lane & 15)) * kLd;
  mma_chunk<MT, NT>(acc, arow, Ws + nb * kLd, lane);
  __syncthreads();   // As is free: the int8 tile is staged over it
  store_int8_tile<BM, MT, NT, kThreads>(acc, As, rb, nb, sx.s, a.kscale, a.bias,
                                        make_quant(a.sq), a.outq, M, m0, tid);
}

// ----------------------------------------------------------------------
// conv3x3: 64 -> 64 channels, stride 1, zero padding 1, int8 in and out
// ----------------------------------------------------------------------
// shared memory: nine weight tiles, a row of zeros, the pixel tile with
// its halo of W + 1 pixels before and after
template <int BM>
int conv3x3_smem(int W) {
  return (9 * 64 + 1 + BM + 2 * W + 2) * kLd;
}

template <int BM, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN)
conv3x3_kernel(const Conv64Args a) {
  constexpr int kThreads = 32 * WM * WN;
  constexpr int MT = BM / (16 * WM), NT = 64 / (8 * WN);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Ws = smem;                    // [9][64] rows
  unsigned char* zeros = Ws + 9 * 64 * kLd;    // one row
  unsigned char* tile = zeros + kLd;           // pixels m0 - W - 1 ...
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rb = (warp % WM) * MT * 16, nb = (warp / WM) * NT * 8;
  const int HW = a.H * a.W;
  const long long M = (long long)a.B * HW;
  const int rows = BM + 2 * a.W + 2;
  const int8_t* x = static_cast<const int8_t*>(a.x);

  // the weights stay for every tile this block takes
  for (int f = tid; f < 9 * 64 * 4; f += kThreads) {
    const int tap = f >> 8, c = (f >> 2) & 63, piece = f & 3;
    cp_async16(Ws + (tap * 64 + c) * kLd + piece * 16, a.w + c * 576 + tap * 64 + piece * 16,
               true);
  }
  if (tid < kLd / 16) reinterpret_cast<uint4*>(zeros)[tid] = make_uint4(0u, 0u, 0u, 0u);
  const float sx = *a.sx;
  const Quant sq = make_quant(a.sq);

  const long long tiles = (M + BM - 1) / BM;
  for (long long m0 = (long long)blockIdx.x * BM; m0 < tiles * BM;
       m0 += (long long)gridDim.x * BM) {
    const long long p0 = m0 - a.W - 1;
    for (int f = tid; f < rows * 4; f += kThreads) {
      const long long p = p0 + (f >> 2);
      const bool ok = p >= 0 && p < M;
      cp_async16(tile + (f >> 2) * kLd + (f & 3) * 16, x + (ok ? p * 64 + (f & 3) * 16 : 0),
                 ok);
    }
    cp_async_wait_all();
    __syncthreads();

    // this lane's pixel of each of the warp's fragments
    int py[MT], px[MT];
    bool pv[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const long long m = m0 + rb + i * 16 + (lane & 15);
      pv[i] = m < M;
      const int r = pv[i] ? (int)(m % HW) : 0;
      py[i] = r / a.W;
      px[i] = r - py[i] * a.W;
    }
    int acc[MT][NT][4];
    clear(acc);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const unsigned char* arow[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int iy = py[i] + dy, ix = px[i] + dx;
        const bool ok = pv[i] && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
        arow[i] =
            ok ? tile + (rb + i * 16 + (lane & 15) + a.W + 1 + dy * a.W + dx) * kLd : zeros;
      }
      mma_chunk<MT, NT>(acc, arow, Ws + (tap * 64 + nb) * kLd, lane);
    }
    __syncthreads();   // the pixel tile is free: the int8 tile is staged over it
    store_int8_tile<BM, MT, NT, kThreads>(acc, tile, rb, nb, sx, a.kscale, a.bias, sq, a.outq,
                                          M, m0, tid);
    __syncthreads();   // and free again for the next tile's pixels
  }
}

// ----------------------------------------------------------------------
// conv256: a block's conv3 (64 -> 256) with the residual add, ReLU and
// the bf16 output. DUAL: block 0, whose identity is the downsample conv
// of the bf16 input, computed here. NEXT: the launch goes on with the
// next block's conv1 (256 -> 64) on the quantized output tile.
// ----------------------------------------------------------------------
struct Conv256Args {
  const int8_t* xq;        // (M, 64) int8: conv2's output
  const int8_t* w;         // (256, 64)
  const float* kscale;     // (256,)
  const float* bias;       // (256,)
  const float* sx;         // conv3's activation scale
  const __nv_bfloat16* x;  // DUAL: the block's bf16 input (M, 64)
  const int8_t* wd;        // DUAL: the downsample's weights, scales, bias
  const float* kscaled;
  const float* biasd;
  const float* sd;         // DUAL: the downsample's activation scale
  // (M, 256) bf16: the residual stream. Read (unless DUAL) and written in
  // place: `residual` may be `out`, so neither is __restrict__.
  const __nv_bfloat16* residual;
  __nv_bfloat16* out;
  const int8_t* w1;        // NEXT: the next conv1's weights (64, 256),
  const float* kscale1;    // scales and bias,
  const float* bias1;
  const float* s1;         // its activation scale, and
  const float* s2;         // the scale of the conv after it
  int8_t* outq;            // NEXT: the next conv1's output (M, 64) int8
  long long M;
};

// shared memory: conv2's tile and conv3's weights (DUAL: twice, for the
// input tile and the downsample's weights), a staged bf16 tile of 128
// channels and, with NEXT, the quantized output as four chunk tiles and
// the next conv1's weights as four chunk tiles of 64 rows
template <int BM>
constexpr int conv256_smem(bool dual, bool next) {
  return (dual ? 2 : 1) * (BM + 256) * kLd + BM * kLdStage * 2 +
         (next ? 4 * (BM + 64) * kLd : 0);
}

template <int BM, int WM, int WN, bool DUAL, bool NEXT>
__global__ void __launch_bounds__(32 * WM * WN)
conv256_kernel(const Conv256Args a) {
  constexpr int kThreads = 32 * WM * WN;
  constexpr int MT = BM / (16 * WM), NT = 128 / (8 * WN), NT1 = 64 / (8 * WN);
  constexpr int kPieces = BM * 16 / kThreads;   // 16-byte pieces a thread and pass
  static_assert(BM * 16 % kThreads == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* As = smem;                    // conv2's int8 tile
  unsigned char* Ws = As + BM * kLd;           // conv3's weights
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(Ws + 256 * kLd);
  unsigned char* more = reinterpret_cast<unsigned char*>(stage + BM * kLdStage);
  unsigned char* Ad = more;                    // DUAL: the quantized input tile
  unsigned char* Wd = Ad + BM * kLd;           // and the downsample's weights
  unsigned char* qt = more + (DUAL ? (BM + 256) * kLd : 0);   // NEXT: [4][BM] rows
  unsigned char* W1 = qt + 4 * BM * kLd;       // and the next conv1's [4][64] rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp % WM) * MT * 16;
  const long long M = a.M;

  // the weights stay for every tile this block takes
  for (int f = tid; f < 256 * 4; f += kThreads) {
    cp_async16(Ws + (f >> 2) * kLd + (f & 3) * 16, a.w + (f >> 2) * 64 + (f & 3) * 16, true);
    if (DUAL)
      cp_async16(Wd + (f >> 2) * kLd + (f & 3) * 16, a.wd + (f >> 2) * 64 + (f & 3) * 16, true);
    if (NEXT)
      cp_async16(W1 + ((f & 3) * 64 + (f >> 4)) * kLd + ((f >> 2) & 3) * 16,
                 a.w1 + (f >> 4) * 256 + (f & 3) * 64 + ((f >> 2) & 3) * 16, true);
  }
  Quant sd, s2;
  if (DUAL) sd = make_quant(a.sd);
  if (NEXT) s2 = make_quant(a.s2);
  const float sx = *a.sx;
  Quant s1;
  if (NEXT) s1 = make_quant(a.s1);
  const unsigned char* arow[MT];

  const long long tiles = (M + BM - 1) / BM;
  for (long long m0 = (long long)blockIdx.x * BM; m0 < tiles * BM;
       m0 += (long long)gridDim.x * BM) {
  for (int f = tid; f < BM * 4; f += kThreads) {
    const bool ok = m0 + (f >> 2) < M;
    cp_async16(As + (f >> 2) * kLd + (f & 3) * 16,
               a.xq + (ok ? (m0 + (f >> 2)) * 64 + (f & 3) * 16 : 0), ok);
  }
  if (DUAL) load_quantized<BM, kThreads>(Ad, a.x, M, m0, sd, tid);
  cp_async_wait_all();
  __syncthreads();

  // acc -> bf16(acc * (s * kscale[c]) + bias[c]) into the staged tile
  auto stage_out = [&](int (&acc)[MT][NT][4], float s, const float* kscale, const float* bias,
                       int c0) {
    const int nb = (warp / WM) * NT * 8;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = nb + j * 8 + 2 * t;
      const float mul0 = __fmul_rn(s, kscale[c0 + c]), mul1 = __fmul_rn(s, kscale[c0 + c + 1]);
      const float b0 = bias[c0 + c], b1 = bias[c0 + c + 1];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(stage + (rb + i * 16 + g + 8 * h) * kLdStage + c) =
              __floats2bfloat162_rn(dequant(acc[i][j][2 * h], mul0, b0),
                                    dequant(acc[i][j][2 * h + 1], mul1, b1));
    }
  };

  for (int pass = 0; pass < 2; ++pass) {
    const int c0 = pass * 128;   // this pass's first output channel
    const int nb = (warp / WM) * NT * 8;
    int acc[MT][NT][4];
    // The identity pieces of this thread, all fetched before any store:
    // `out` may alias `residual`, so the compiler would not move a load
    // above a store, and the loads would wait for each other.
    uint4 idv[kPieces];
    if (DUAL) {
      clear(acc);
#pragma unroll
      for (int i = 0; i < MT; ++i) arow[i] = Ad + (rb + i * 16 + (lane & 15)) * kLd;
      mma_chunk<MT, NT>(acc, arow, Wd + (c0 + nb) * kLd, lane);
      stage_out(acc, sd.s, a.kscaled, a.biasd, c0);
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kPieces; ++e) {
        const int f = tid + e * kThreads;
        idv[e] = *reinterpret_cast<const uint4*>(stage + (f >> 4) * kLdStage + (f & 15) * 8);
      }
      __syncthreads();   // the staged tile is free for conv3's values
    } else {
#pragma unroll
      for (int e = 0; e < kPieces; ++e) {
        const int f = tid + e * kThreads;
        const long long m = m0 + (f >> 4);
        idv[e] = make_uint4(0u, 0u, 0u, 0u);
        if (m < M)
          idv[e] = *reinterpret_cast<const uint4*>(a.residual + m * 256 + c0 + (f & 15) * 8);
      }
    }
    clear(acc);
#pragma unroll
    for (int i = 0; i < MT; ++i) arow[i] = As + (rb + i * 16 + (lane & 15)) * kLd;
    mma_chunk<MT, NT>(acc, arow, Ws + (c0 + nb) * kLd, lane);
    stage_out(acc, sx, a.kscale, a.bias, c0);
    __syncthreads();

    // 16 bytes (8 channels) a thread: + identity, ReLU, store, quantize
#pragma unroll
    for (int e = 0; e < kPieces; ++e) {
      const int f = tid + e * kThreads, r = f >> 4, c = (f & 15) * 8;
      const long long m = m0 + r;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + r * kLdStage + c);
      const __nv_bfloat162* vh = reinterpret_cast<const __nv_bfloat162*>(&v);
      const __nv_bfloat162* ih = reinterpret_cast<const __nv_bfloat162*>(&idv[e]);
      uint4 o;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&o);
      union { int8_t b[8]; uint2 u; } q;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 x2 = __bfloat1622float2(vh[k]), i2 = __bfloat1622float2(ih[k]);
        const float y0 = fmaxf(round_bf16(__fadd_rn(x2.x, i2.x)), 0.f);
        const float y1 = fmaxf(round_bf16(__fadd_rn(x2.y, i2.y)), 0.f);
        oh[k] = __floats2bfloat162_rn(y0, y1);
        if (NEXT) {
          q.b[2 * k] = quantize(y0, s1);
          q.b[2 * k + 1] = quantize(y1, s1);
        }
      }
      if (m < M) *reinterpret_cast<uint4*>(a.out + m * 256 + c0 + c) = o;
      // channel c0 + c lies in chunk (c0 + c) / 64 of the next conv's K
      if (NEXT)
        *reinterpret_cast<uint2*>(qt + (((c0 + c) >> 6) * BM + r) * kLd + ((c0 + c) & 63)) = q.u;
    }
    __syncthreads();   // the staged tile is free for the next pass
  }

  if (NEXT) {
    // the next block's conv1 on the quantized tile
    const int nb1 = (warp / WM) * NT1 * 8;
    int acc1[MT][NT1][4];
    clear(acc1);
#pragma unroll
    for (int chunk = 0; chunk < 4; ++chunk) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        arow[i] = qt + (chunk * BM + rb + i * 16 + (lane & 15)) * kLd;
      mma_chunk<MT, NT1>(acc1, arow, W1 + (chunk * 64 + nb1) * kLd, lane);
    }
    // the staged bf16 tile is free (BM rows of 272 bytes): the int8 tile
    // goes there; the next tile's first write to it comes after a barrier
    store_int8_tile<BM, MT, NT1, kThreads>(acc1, reinterpret_cast<unsigned char*>(stage), rb,
                                           nb1, s1.s, a.kscale1, a.bias1, s2, a.outq, M, m0,
                                           tid);
  }
  }
}

// The tile by the pixel count (ops/resnet_kernel.py::pixel_tile): 128
// pixels and 8 warps (4 x 2) for the convs with 64 output channels and
// 64 pixels (2 x 4) for conv256, or 16 pixels and 4 warps (1 x 4) where
// the large tile would not give every SM a block.
int launch_conv1x1_in(const Conv64Args& a, bool small, cudaStream_t stream) {
  const long long M = (long long)a.B * a.H * a.W;
  if (small)
    conv1x1_in_kernel<16, 1, 4><<<(unsigned)((M + 15) / 16), 128, 0, stream>>>(a);
  else
    conv1x1_in_kernel<128, 4, 2><<<(unsigned)((M + 127) / 128), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// A kernel that walks over tiles: allow its shared memory and find how
// many blocks the card holds at once (kept per device, and per `key`,
// the value the shared-memory size depends on).
constexpr int kMaxDevices = 16;
struct Resident {
  int key[kMaxDevices], blocks[kMaxDevices];
};

template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int smem, int key, Resident* r, int* blocks) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (r->blocks[dev] == 0 || r->key[dev] != key) {
    int per_sm, sms;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                             smem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    r->key[dev] = key;
    r->blocks[dev] = per_sm * sms;
  }
  *blocks = r->blocks[dev];
  return 0;
}

template <int BM, int WM, int WN>
int launch_conv3x3_tile(const Conv64Args& a, cudaStream_t stream) {
  static Resident resident = {};
  const long long tiles = ((long long)a.B * a.H * a.W + BM - 1) / BM;
  const int smem = conv3x3_smem<BM>(a.W);
  auto kernel = conv3x3_kernel<BM, WM, WN>;
  int blocks;
  const int err = resident_blocks(kernel, 32 * WM * WN, smem, a.W, &resident, &blocks);
  if (err) return err;
  kernel<<<(unsigned)(tiles < blocks ? tiles : blocks), 32 * WM * WN, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_conv3x3(const Conv64Args& a, bool small, cudaStream_t stream) {
  return small ? launch_conv3x3_tile<16, 1, 4>(a, stream)
               : launch_conv3x3_tile<128, 4, 2>(a, stream);
}

template <int BM, int WM, int WN, bool DUAL, bool NEXT>
int launch_conv256_tile(const Conv256Args& a, cudaStream_t stream) {
  static Resident resident = {};
  constexpr int smem = conv256_smem<BM>(DUAL, NEXT);
  const long long tiles = (a.M + BM - 1) / BM;
  auto kernel = conv256_kernel<BM, WM, WN, DUAL, NEXT>;
  int blocks;
  const int err = resident_blocks(kernel, 32 * WM * WN, smem, 0, &resident, &blocks);
  if (err) return err;
  kernel<<<(unsigned)(tiles < blocks ? tiles : blocks), 32 * WM * WN, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool DUAL, bool NEXT>
int launch_conv256(const Conv256Args& a, bool small, cudaStream_t stream) {
  return small ? launch_conv256_tile<16, 1, 4, DUAL, NEXT>(a, stream)
               : launch_conv256_tile<64, 2, 4, DUAL, NEXT>(a, stream);
}

}  // namespace

// x: (B, H, W, 64) bf16. wq/kscale/bias/ascale: ten device pointers
// each, in _CONV_ORDER (b0 conv1, conv2, conv3, downsample; b1
// conv1..3; b2 conv1..3); ascale[i] points at conv i's f32 activation
// scale. scratch: M x 128 bytes (the two M x 64 int8 maps between the
// convs of a block). out: (B, H, W, 256) bf16, which also carries the
// residual stream. tile: 128 or 16 pixels a block. Shapes and alignment
// are checked by the wrapper (ops/resnet_kernel.py).
extern "C" int mec_layer1_int8(const void* x, int B, int H, int W, const void* const* wq,
                               const float* const* kscale, const float* const* bias,
                               const float* const* ascale, void* scratch, void* out, int tile,
                               void* stream) {
  const long long M = (long long)B * H * W;
  // the 3x3 conv holds a tile and its halo of 2 W + 2 pixels on chip
  if ((tile != 128 && tile != 16) || W < 1 || conv3x3_smem<128>(W) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const bool small = tile == 16;
  cudaStream_t s = (cudaStream_t)stream;
  int8_t* h1q = static_cast<int8_t*>(scratch);
  int8_t* h2q = h1q + M * 64;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  int err;

  // conv i: `in` -> int8 `outq`, quantized for conv `next`
  auto conv64 = [&](int i, const void* in, int8_t* outq, int next) {
    Conv64Args a;
    a.x = in;
    a.w = static_cast<const int8_t*>(wq[i]);
    a.kscale = kscale[i];
    a.bias = bias[i];
    a.sx = ascale[i];
    a.sq = ascale[next];
    a.outq = outq;
    a.B = B; a.H = H; a.W = W;
    return a;
  };
  // conv3 `i` of a block: h2q -> out (+ identity), then conv1 `next` of
  // the block after it -> h1q
  auto conv256 = [&](int i, int next) {
    Conv256Args a = {};
    a.xq = h2q;
    a.w = static_cast<const int8_t*>(wq[i]);
    a.kscale = kscale[i];
    a.bias = bias[i];
    a.sx = ascale[i];
    a.residual = o;
    a.out = o;
    if (next >= 0) {
      a.w1 = static_cast<const int8_t*>(wq[next]);
      a.kscale1 = kscale[next];
      a.bias1 = bias[next];
      a.s1 = ascale[next];
      a.s2 = ascale[next + 1];
      a.outq = h1q;
    }
    a.M = M;
    return a;
  };

  // block 0: the identity is downsample(x), computed with conv3
  if ((err = launch_conv1x1_in(conv64(0, x, h1q, 1), small, s))) return err;
  if ((err = launch_conv3x3(conv64(1, h1q, h2q, 2), small, s))) return err;
  Conv256Args d = conv256(2, 4);
  d.x = static_cast<const __nv_bfloat16*>(x);
  d.wd = static_cast<const int8_t*>(wq[3]);
  d.kscaled = kscale[3];
  d.biasd = bias[3];
  d.sd = ascale[3];
  d.residual = nullptr;
  if ((err = launch_conv256<true, true>(d, small, s))) return err;
  // blocks 1 and 2: the identity is the residual stream in `out`
  if ((err = launch_conv3x3(conv64(5, h1q, h2q, 6), small, s))) return err;
  if ((err = launch_conv256<false, true>(conv256(6, 7), small, s))) return err;
  if ((err = launch_conv3x3(conv64(8, h1q, h2q, 9), small, s))) return err;
  return launch_conv256<false, false>(conv256(9, -1), small, s);
}
