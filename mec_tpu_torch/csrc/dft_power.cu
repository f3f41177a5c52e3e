// K5 dft_power: windowed frames -> power and magnitude spectrograms.
//
// Replaces: mec_tpu/ops/pallas_kernels.py::dft_spectrograms (kernel
// _make_dft_power_kernel). For frames A (M, K = 2048) and the DFT bases
// C, S (K, N = 1025), C[n][k] = cos(2 pi n k / K), S[n][k] = -sin(...):
//   re = A @ C, im = A @ S, P = re*re + im*im, mag = sqrt(P),
// both written as (M, N) fp32, unpadded. Two precisions, two kernels:
//   highest: fp32 operands and fp32 FMAs on the CUDA cores (no TF32: the
//            TPU kernel's contract is a full fp32 product);
//   bf16:    the frames are rounded to bf16 (RNE) on their way into
//            shared memory, the bases arrive as bf16 tensors (the wrapper
//            rounds them once), and the tensor cores sum the products,
//            which are exact in fp32, in fp32: the TPU kernel's one-pass
//            DEFAULT precision.
//
// What bounds it on this card (H100 SXM data sheet). At B = 32 (M = 4160)
// the two products are 4 M K N = 34.9 GFLOP against ~85 MB (68 MB of it
// the two outputs): 'highest' is bound by the fp32 FMA rate (67 TFLOP/s,
// 0.52 ms); 'bf16' by the tensor cores (989 TFLOP/s, 0.035 ms) with the
// memory side (0.025 ms) close behind, so its epilogue matters as much
// as its main loop.
//
// Design, common to both kernels:
// * N = 1025 = 16 * 64 + 1. The 1024 bins below the Nyquist bin are cut
//   into tiles (at B = 32: 16 x 33 = 528 blocks of 128 frames x 64 bins,
//   four full waves at one block per SM, two at two). The Nyquist bin of
//   a row tile is a plain dot product per frame, and the row tile's
//   blocks share its frames among their warps, so every block does the
//   same work. The base values of that bin come from the same tables
//   (cos = +-1, sin = the table's rounding noise), so no value moves.
// * A block computes its tile against BOTH bases, so re and im of a bin
//   meet in registers and P is formed there.
// * K advances 32 at a time through a ring of three shared-memory stages
//   filled by cp.async (16 bytes a copy, zero-filled past row M), one
//   barrier per step. The wrapper hands over tables whose rows are
//   16-byte aligned: fp32 (K, 1024) plus the Nyquist columns for
//   'highest'; bf16 K-major (1032, K), row 1024 the Nyquist bin, for
//   'bf16'.
// * Output rows are 4,100 bytes, so only 4-byte stores are aligned. The
//   tile of P is staged in shared memory (over the ring, once the loop
//   is done) and written so that a warp stores consecutive bins of one
//   row; mag = sqrt(P) is formed on the way out. The rounding points of
//   the plain version stay: P = rn(rn(re*re) + rn(im*im)), no FMA
//   contraction, and a correctly rounded sqrt.
// * Small M: at B = 1 (M = 130) the 128 x 64 tile gives 32 blocks, so
//   the wrapper picks a 32 x 32 tile there (160 blocks on 132 SMs).
//
// 'bf16' uses mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with all
// fragments from ldmatrix, not wgmma: with 68 MB of output the kernel
// cannot be much faster than ~0.05 ms whatever the instruction, and
// mma.sync reads plain padded rows (80 bytes: every ldmatrix is
// conflict-free) where wgmma wants swizzled tiles that a descriptor must
// match. The bases are copied by cp.async; the fp32 frames cannot be (a
// copy cannot round), so they pass through registers: fetched when their
// step is two steps away, rounded and stored into their stage after the
// current step's products, so the fetch has a step's work to hide
// behind. One ldmatrix.x4 fetches the cos and the sin fragment of an
// 8-bin column together (the tile holds the cos rows of its bins, then
// the sin rows). 8 warps: 4 x 2 over the 128 x 64 tile (32 frames x 32
// bins x 2 bases a warp, 64 accumulators a thread, 128 registers, two
// blocks per SM), 2 x 4 over the 32 x 32 one. Measured on the card
// (NVIDIA H100 80GB HBM3, 700 W; bench/kernel_ab.py --profile, B = 32),
// neither the shared-memory traffic (frames kept as fp32 in shared
// memory and rounded at the fragment load: 163 against 157 us), nor the
// bytes out of the L2 cache (a 128 x 128 tile on 8 or on 16 warps: 168
// and 161 us), nor a fourth stage (157 us) moves this kernel: what is
// left is the un-pipelined ldmatrix -> mma sequence inside a step and
// the epilogue's 68 MB, which the blocks of a wave write together.
//
// 'highest' keeps 256 threads with an (8 frames x 4 bins x 2 bases)
// register tile and fp32 frames in shared memory (rows padded to 40
// floats). The frames of a thread are 16 rows apart, so the two rows a
// warp reads in one instruction lie 40 floats apart (no bank conflict),
// and with no prefetch registers it fits 128 registers: two blocks (16
// warps) per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;         // contraction step per stage
constexpr int kStages = 3;
constexpr int kLdA = kBK + 8;   // floats per frame-tile row (160 bytes)
constexpr int kLdB = kBK + 8;   // bf16 per basis-tile row (80 bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// frames tile: BM rows x 32 floats, 8 copies of 16 bytes a row
template <int BM>
__device__ __forceinline__ void load_frames(float* As, const float* __restrict__ frames, int M,
                                            int K, int m0, int k0, int tid) {
#pragma unroll
  for (int e = 0; e < BM * 8 / kThreads; ++e) {
    const int f = tid + e * kThreads, r = f >> 3, c = f & 7;
    const bool ok = m0 + r < M;
    cp_async16(As + r * kLdA + c * 4, frames + (size_t)(ok ? m0 + r : 0) * K + k0 + c * 4, ok);
  }
}

// The staged tile of P (BM x BN, row stride BN + 8 floats) -> P and mag:
// a warp writes consecutive bins of one row.
template <int BM, int BN, int kWarpsT>
__device__ __forceinline__ void store_tile(const float* Ps, int M, int N, int m0, int n0,
                                           float* __restrict__ P, float* __restrict__ mag,
                                           int warp, int lane) {
  for (int r = warp; r < BM; r += kWarpsT) {
    const int m = m0 + r;
    if (m >= M) break;
#pragma unroll
    for (int c = lane; c < BN; c += 32) {
      const float p = Ps[r * (BN + 8) + c];
      const size_t o = (size_t)m * N + n0 + c;
      P[o] = p;
      mag[o] = __fsqrt_rn(p);
    }
  }
}

__device__ __forceinline__ float power(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The Nyquist bin (column N - 1) of this block's share of its row tile:
// the tile's BM rows are dealt out to the gridDim.x blocks of the row
// tile, one row a warp at a time. nyq_cos/nyq_sin: that bin's K basis
// values, fp32 ('highest') or bf16.
template <bool kBf16, int BM, int kWarpsT>
__device__ __forceinline__ void nyquist_bin(const float* __restrict__ frames,
                                            const void* __restrict__ nyq_cos,
                                            const void* __restrict__ nyq_sin, int M, int K, int N,
                                            int m0, float* __restrict__ P,
                                            float* __restrict__ mag, int warp, int lane) {
  const int per = (BM + gridDim.x - 1) / gridDim.x;
  const int r1 = min((int)(blockIdx.x + 1) * per, BM);
  for (int r = blockIdx.x * per + warp; r < r1; r += kWarpsT) {
    const int m = m0 + r;
    if (m >= M) break;
    float re = 0.f, im = 0.f;
    for (int k = lane * 4; k < K; k += 128) {
      const float4 a4 = *reinterpret_cast<const float4*>(frames + (size_t)m * K + k);
      float a[4] = {a4.x, a4.y, a4.z, a4.w}, c[4], s[4];
      if (kBf16) {
        const uint2 cu = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(nyq_cos) + k);
        const uint2 su = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(nyq_sin) + k);
        const float2 c0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cu.x));
        const float2 c1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cu.y));
        const float2 s0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&su.x));
        const float2 s1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&su.y));
        c[0] = c0.x; c[1] = c0.y; c[2] = c1.x; c[3] = c1.y;
        s[0] = s0.x; s[1] = s0.y; s[2] = s1.x; s[3] = s1.y;
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = round_bf16(a[i]);
      } else {
        const float4 c4 = *reinterpret_cast<const float4*>(
            static_cast<const float*>(nyq_cos) + k);
        const float4 s4 = *reinterpret_cast<const float4*>(
            static_cast<const float*>(nyq_sin) + k);
        c[0] = c4.x; c[1] = c4.y; c[2] = c4.z; c[3] = c4.w;
        s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        re = fmaf(a[i], c[i], re);
        im = fmaf(a[i], s[i], im);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      re = __fadd_rn(re, __shfl_xor_sync(0xffffffffu, re, off));
      im = __fadd_rn(im, __shfl_xor_sync(0xffffffffu, im, off));
    }
    if (lane == 0) {
      const float p = power(re, im);
      const size_t o = (size_t)m * N + N - 1;
      P[o] = p;
      mag[o] = __fsqrt_rn(p);
    }
  }
}

// ----------------------------------------------------------------------
// 'highest': fp32 FMAs. cosb/sinb: (K, N - 1) fp32, row-major.
// ----------------------------------------------------------------------
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
dft_power_fp32_kernel(const float* __restrict__ frames, const float* __restrict__ cosb,
                      const float* __restrict__ sinb, const float* __restrict__ nyq_cos,
                      const float* __restrict__ nyq_sin, int M, int K, int N,
                      float* __restrict__ P, float* __restrict__ mag) {
  constexpr int TX = BN / 4;          // threads along the bins, 4 bins each
  constexpr int TY = kThreads / TX;   // threads along the frames
  constexpr int TM = BM / TY;         // frames per thread, TY rows apart
  constexpr int kStageFloats = BM * kLdA + 2 * kBK * BN;
  static_assert(BM % TY == 0 && BM * (BN + 8) <= kStages * kStageFloats, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ld = N - 1;               // bins in the fp32 tables

  auto load = [&](int stage, int step) {
    float* As = smem + stage * kStageFloats;
    float* Cs = As + BM * kLdA;
    float* Ss = Cs + kBK * BN;
    const int k0 = step * kBK;
    load_frames<BM>(As, frames, M, K, m0, k0, tid);
#pragma unroll
    for (int e = 0; e < kBK * TX / kThreads; ++e) {
      const int f = tid + e * kThreads, k = f / TX, c = f % TX;
      const size_t off = (size_t)(k0 + k) * ld + n0 + c * 4;
      cp_async16(Cs + k * BN + c * 4, cosb + off, true);
      cp_async16(Ss + k * BN + c * 4, sinb + off, true);
    }
  };

  float re[TM][4], im[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

  const int steps = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // the copies of step s have landed, and every thread is done with
    // step s - 1, whose stage the next copies overwrite
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = s + kStages - 1;
    if (nxt < steps) load(nxt % kStages, nxt);
    cp_async_commit();
    const float* As = smem + (s % kStages) * kStageFloats;
    const float* Cs = As + BM * kLdA;
    const float* Ss = Cs + kBK * BN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 2) {
      float2 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float2*>(As + (ty + TY * i) * kLdA + kk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 c = *reinterpret_cast<const float4*>(Cs + (kk + h) * BN + tx * 4);
        const float4 sn = *reinterpret_cast<const float4*>(Ss + (kk + h) * BN + tx * 4);
        const float cv[4] = {c.x, c.y, c.z, c.w};
        const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = h ? a[i].y : a[i].x;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            re[i][j] = fmaf(av, cv[j], re[i][j]);
            im[i][j] = fmaf(av, sv[j], im[i][j]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();    // the ring is free: stage the tile of P over it

  float* Ps = smem;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float4 p;
    p.x = power(re[i][0], im[i][0]);
    p.y = power(re[i][1], im[i][1]);
    p.z = power(re[i][2], im[i][2]);
    p.w = power(re[i][3], im[i][3]);
    *reinterpret_cast<float4*>(Ps + (ty + TY * i) * (BN + 8) + tx * 4) = p;
  }
  __syncthreads();
  store_tile<BM, BN, kWarps>(Ps, M, N, m0, n0, P, mag, warp, lane);
  nyquist_bin<false, BM, kWarps>(frames, nyq_cos, nyq_sin, M, K, N, m0, P, mag, warp, lane);
}

// ----------------------------------------------------------------------
// 'bf16': tensor cores. cosT/sinT: (>= N, K) bf16, K-major (row n holds
// bin n's K basis values).
// ----------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);   // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN, WM * WN > 8 ? 1 : 2)
dft_power_bf16_kernel(const float* __restrict__ frames, const __nv_bfloat16* __restrict__ cosT,
                      const __nv_bfloat16* __restrict__ sinT, int M, int K, int N,
                      float* __restrict__ P, float* __restrict__ mag) {
  constexpr int kT = 32 * WM * WN;        // threads a block
  constexpr int MT = BM / (16 * WM);   // 16-frame fragments per warp
  constexpr int NT = BN / (8 * WN);    // 8-bin fragments per warp and base
  constexpr int AP = BM * 8 / kT;   // float4 of the frame tile per thread
  constexpr int kStageHalfs = (BM + 2 * BN) * kLdB;
  static_assert(BM % (16 * WM) == 0 && BN % (8 * WN) == 0 && BM * 8 % kT == 0 &&
                BM * (BN + 8) * 4 <= kStages * kStageHalfs * 2, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp % WM) * MT * 16;   // the warp's first frame of the tile
  const int nb = (warp / WM) * NT * 8;    // and its first bin
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // A stage: BM rows of frames, then BN rows of cos and BN rows of sin
  // values (the tile's bins), each row 32 bf16 padded to 40.
  // The frames pass through registers, where they are rounded to bf16:
  // fetched a step ahead of the copy into their stage.
  float4 areg[AP];
  auto fetch_frames = [&](int step) {
#pragma unroll
    for (int e = 0; e < AP; ++e) {
      const int f = tid + e * kT, r = f >> 3, c = f & 7;
      areg[e] = m0 + r < M ? *reinterpret_cast<const float4*>(
                                 frames + (size_t)(m0 + r) * K + step * kBK + c * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_frames = [&](int stage) {
    __nv_bfloat16* As = smem + stage * kStageHalfs;
#pragma unroll
    for (int e = 0; e < AP; ++e) {
      const int f = tid + e * kT, r = f >> 3, c = f & 7;
      uint2 v;
      v.x = pack_bf16(make_float2(areg[e].x, areg[e].y));
      v.y = pack_bf16(make_float2(areg[e].z, areg[e].w));
      *reinterpret_cast<uint2*>(As + r * kLdB + c * 4) = v;
    }
  };
  auto load_bases = [&](int stage, int step) {
    __nv_bfloat16* Bs = smem + stage * kStageHalfs + BM * kLdB;
#pragma unroll
    for (int e = 0; e < 2 * BN * 4 / kT; ++e) {
      const int f = tid + e * kT, row = f >> 2, c = f & 3;
      const __nv_bfloat16* src = (row < BN ? cosT : sinT) +
                                 (size_t)(n0 + row % BN) * K + step * kBK + c * 8;
      cp_async16(Bs + row * kLdB + c * 8, src, true);
    }
  };

  float re[MT][NT][4], im[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) re[i][j][e] = im[i][j][e] = 0.f;

  const int steps = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_bases(s, s);
      fetch_frames(s);
      store_frames(s);
    }
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // the bases of step s have landed and its frames were stored before
    // the last barrier but one; every thread is done with step s - 1,
    // whose stage takes step s + 2
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = s + kStages - 1;
    if (nxt < steps) {
      load_bases(nxt % kStages, nxt);
      fetch_frames(nxt);
    }
    cp_async_commit();
    const __nv_bfloat16* As = smem + (s % kStages) * kStageHalfs;
    const __nv_bfloat16* Bs = As + BM * kLdB;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // A fragments: lanes 0-15 address rows 0-15 at k 0-7, lanes 16-31
      // the same rows at k 8-15
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], As + (rb + i * 16 + (lane & 15)) * kLdB + ks + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // lanes 0-15 address the cos rows of this 8-bin column (k 0-7,
        // then k 8-15), lanes 16-31 the sin rows
        uint32_t b[4];
        ldmatrix_x4(b, Bs + ((lane >> 4) * BN + nb + j * 8 + (lane & 7)) * kLdB + ks +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(re[i][j], a[i], b[0], b[1]);
          mma_bf16(im[i][j], a[i], b[2], b[3]);
        }
      }
    }
    if (nxt < steps) store_frames(nxt % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();    // the ring is free: stage the tile of P over it

  // an accumulator fragment holds rows g and g + 8, bins 2t and 2t + 1
  float* Ps = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float* pp = Ps + (rb + i * 16 + g) * (BN + 8) + nb + j * 8 + 2 * t;
      *reinterpret_cast<float2*>(pp) =
          make_float2(power(re[i][j][0], im[i][j][0]), power(re[i][j][1], im[i][j][1]));
      *reinterpret_cast<float2*>(pp + 8 * (BN + 8)) =
          make_float2(power(re[i][j][2], im[i][j][2]), power(re[i][j][3], im[i][j][3]));
    }
  __syncthreads();
  store_tile<BM, BN, WM * WN>(Ps, M, N, m0, n0, P, mag, warp, lane);
  nyquist_bin<true, BM, WM * WN>(frames, cosT + (size_t)(N - 1) * K, sinT + (size_t)(N - 1) * K, M, K, N,
                        m0, P, mag, warp, lane);
}

// Allow a kernel its dynamic shared memory, once per device.
constexpr int kMaxDevices = 16;
template <typename Kernel>
int allow_smem(Kernel kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    done[dev] = true;
  }
  return 0;
}

template <int BM, int BN>
int launch_fp32(const float* frames, const float* cosb, const float* sinb, const float* nyq,
                int M, int K, int N, float* P, float* mag, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  constexpr int smem = kStages * (BM * kLdA + 2 * kBK * BN) * 4;
  auto kernel = dft_power_fp32_kernel<BM, BN>;
  const int err = allow_smem(kernel, smem, done);
  if (err) return err;
  const dim3 grid((N - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(frames, cosb, sinb, nyq, nyq + K, M, K, N, P, mag);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int WM, int WN>
int launch_bf16(const float* frames, const __nv_bfloat16* cosT, const __nv_bfloat16* sinT, int M,
                int K, int N, float* P, float* mag, cudaStream_t stream) {
  static bool done[kMaxDevices] = {};
  constexpr int smem = kStages * (BM + 2 * BN) * kLdB * 2;
  auto kernel = dft_power_bf16_kernel<BM, BN, WM, WN>;
  const int err = allow_smem(kernel, smem, done);
  if (err) return err;
  const dim3 grid((N - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, 32 * WM * WN, smem, stream>>>(frames, cosT, sinT, M, K, N, P, mag);
  return (int)cudaGetLastError();
}

}  // namespace

// frames (M, K) fp32, 16-byte aligned. bf16 == 0 ('highest'): cosb, sinb
// are (K, N - 1) fp32 and nyq is (2, K) fp32, the Nyquist bin's cos and
// sin values. bf16 != 0: cosb, sinb are (>= N, K) bf16, K-major, and nyq
// is not read. bm x bn is the tile the wrapper picked (128 x 64 or
// 32 x 32, ops/dft_kernel.py::tile_grid). P, mag: (M, N) fp32.
extern "C" int mec_dft_power(const float* frames, const void* cosb, const void* sinb,
                             const float* nyq, int M, int K, int N, int bf16, int bm, int bn,
                             float* P, float* mag, void* stream) {
  const bool large = bm == 128 && bn == 64, small = bm == 32 && bn == 32;
  if (K <= 0 || K % 128 != 0 || N < 2 || (N - 1) % 64 != 0 || M < 0 || !(large || small))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(cosb);
    const __nv_bfloat16* sn = static_cast<const __nv_bfloat16*>(sinb);
    return large ? launch_bf16<128, 64, 4, 2>(frames, c, sn, M, K, N, P, mag, s)
                 : launch_bf16<32, 32, 2, 4>(frames, c, sn, M, K, N, P, mag, s);
  }
  const float* c = static_cast<const float*>(cosb);
  const float* sn = static_cast<const float*>(sinb);
  return large ? launch_fp32<128, 64>(frames, c, sn, nyq, M, K, N, P, mag, s)
               : launch_fp32<32, 32>(frames, c, sn, nyq, M, K, N, P, mag, s);
}
