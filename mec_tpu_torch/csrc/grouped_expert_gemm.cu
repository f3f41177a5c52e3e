// grouped_expert_gemm: the routed and shared SwiGLU experts of one
// mixture-of-experts layer (Moonlight-16B-A3B, deepseek_v3 layout) as two
// grouped GEMMs over the layer's token-expert pairs, sorted by expert.
//
// Replaces no TPU kernel: the JAX package has no decoder with top-k
// experts (its MoE BERT is top-1 with a capacity, models/moe.py). It was
// added because a dropless top-6 layer has a different number of rows
// for every expert in every step, decided on the device by the router,
// and a CUDA graph of the step cannot wait for the host to learn them.
// The per-expert row offsets are computed on the device (ops/
// expert_gemm.py::route) and read here; the grid covers the static worst
// case and blocks past the step's tiles return at once.
//
//   gate_up   h[p] = silu(x[src[p]] . Wg_e^T) * (x[src[p]] . Wu_e^T), bf16
//   down      y[p] = w[p] * (h[p] . Wd_e^T), float32
//
// p is a pair's position in the sorted order, e its expert: experts
// 0 .. n_routed-1 are the routed ones, stacked (E, N, K) for gate and up
// and (E, H, I) for down, and the rest are the shared experts, each one
// I-wide slice of the published shared SwiGLU (gate and up rows s*I ..,
// down columns s*I .., row stride S*I), every real token's pair with
// weight 1. The caller sums a token's pairs in float32 in a fixed order.
//
// What bounds it on this card (H100 SXM data sheet). At one request of
// ~16 tokens a layer touches ~51 of its 64 experts: 17.3 MB of bf16
// weights an expert against ~12 rows of work, so the kernel is bound by
// the bytes of the touched experts' weights (3.35 TB/s). At 32 requests
// of 128 tokens every expert holds ~380 rows and the shared ones 4,096:
// 2 x 3 x 2048 x 1408 operations a pair, bound by the bf16 tensor-core
// rate (989 TFLOP/s).
//
// Design: a block computes a BM x 64 tile of one expert (BM 16 when the
// step has at most 256 tokens, else 64) over the whole K, on
// mma.sync m16n8k16 bf16 with float32 sums; four warps; a four-stage
// cp.async ring of 64-wide K slices, 16 bytes a copy, rows swizzled by
// XOR of the 16-byte chunk with the row so that every ldmatrix is
// conflict-free. gate_up loads the gate and up slices of the same 64
// columns and applies SwiGLU in the epilogue, so h is written once, in
// bf16; down scales by the pair's routing weight in the epilogue. The
// A rows of gate_up are gathered through src (the token of each pair),
// zero-filled past the expert's last row, whose outputs are not stored.
// blockIdx.x walks the tiles (expert-major: an expert's row tiles are
// neighbours, so they share its weight slice in L2), blockIdx.y the
// 64-column slices. An expert without rows has no tile and reads none of
// its weights.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "per_device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kMaxExperts = 255;   // routed and shared experts a layer

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 offset of 16-byte chunk c (0-7) of row r in a tile of 64-wide rows
__device__ __forceinline__ int swz(int r, int c) { return r * kBK + ((c ^ (r & 7)) << 3); }

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <int BM, bool kGated>
__global__ void __launch_bounds__(kThreads)
grouped_expert_kernel(const __nv_bfloat16* __restrict__ a, const int* __restrict__ src,
                      const int* __restrict__ offsets, const float* __restrict__ pair_w,
                      const __nv_bfloat16* __restrict__ w0_r,
                      const __nv_bfloat16* __restrict__ w1_r,
                      const __nv_bfloat16* __restrict__ w0_s,
                      const __nv_bfloat16* __restrict__ w1_s, int n_routed, int n_experts,
                      int K, int N, void* __restrict__ out) {
  constexpr int kWarpsM = BM == 16 ? 1 : 2;
  constexpr int kWarpsN = 4 / kWarpsM;
  constexpr int MI = BM / kWarpsM / 16;        // 16-row fragments a warp
  constexpr int NI = kBN / kWarpsN / 8;        // 8-column fragments a warp
  constexpr int kB = kGated ? 2 : 1;           // weight slices a stage
  constexpr int kStageElems = (BM + kB * kBN) * kBK;
  constexpr int kAChunks = BM * 8 / kThreads;  // A copies a thread a stage
  static_assert(BM * 8 % kThreads == 0 && NI % 2 == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ int s_off[kMaxExperts + 1];
  __shared__ int tile[3];   // expert, first sorted row, rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the offsets in one parallel read; one thread then finds the tile
  for (int i = tid; i <= n_experts; i += kThreads) s_off[i] = offsets[i];
  __syncthreads();
  if (tid == 0) {
    int t = blockIdx.x, e = 0, found = -1, m0 = 0, rows = 0;
    for (; e < n_experts; ++e) {
      const int lo = s_off[e], hi = s_off[e + 1];
      const int tiles = (hi - lo + BM - 1) / BM;
      if (t < tiles) {
        found = e;
        m0 = lo + t * BM;
        rows = min(BM, hi - m0);
        break;
      }
      t -= tiles;
    }
    tile[0] = found;
    tile[1] = m0;
    tile[2] = rows;
  }
  __syncthreads();
  const int e = tile[0], m0 = tile[1], rows = tile[2];
  if (e < 0) return;
  const int n0 = blockIdx.y * kBN;

  // this expert's weight slices and their row stride
  const __nv_bfloat16 *B0, *B1 = nullptr;
  long long ldb = K;
  if (e < n_routed) {
    B0 = w0_r + (long long)e * N * K;
    if (kGated) B1 = w1_r + (long long)e * N * K;
  } else if (kGated) {
    B0 = w0_s + (long long)(e - n_routed) * N * K;
    B1 = w1_s + (long long)(e - n_routed) * N * K;
  } else {
    B0 = w0_s + (long long)(e - n_routed) * K;
    ldb = (long long)(n_experts - n_routed) * K;
  }

  // each thread's A rows: gathered through src in gate_up, in order in down
  const __nv_bfloat16* arow[kAChunks];
  bool aok[kAChunks];
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int r = (tid + i * kThreads) >> 3;
    aok[i] = r < rows;
    const long long row = aok[i] ? (kGated ? (long long)src[m0 + r] : (long long)(m0 + r)) : 0;
    arow[i] = a + row * K;
  }

  auto load_stage = [&](int stage, int kt) {
    __nv_bfloat16* As = smem + stage * kStageElems;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int f = tid + i * kThreads, r = f >> 3, c = f & 7;
      cp_async16(As + swz(r, c), arow[i] + k0 + c * 8, aok[i]);
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      __nv_bfloat16* Bs = As + BM * kBK + b * kBN * kBK;
      const __nv_bfloat16* W = b == 0 ? B0 : B1;
#pragma unroll
      for (int i = 0; i < kBN * 8 / kThreads; ++i) {
        const int f = tid + i * kThreads, r = f >> 3, c = f & 7;
        cp_async16(Bs + swz(r, c), W + (n0 + r) * ldb + k0 + c * 8, true);
      }
    }
  };

  float acc[kB][MI][NI][4];
#pragma unroll
  for (int b = 0; b < kB; ++b)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[b][i][j][q] = 0.f;

  const int rb = (warp % kWarpsM) * MI * 16;   // the warp's first row of the tile
  const int nb = (warp / kWarpsM) * NI * 8;    // and its first column
  const int KT = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // slice kt has landed, and every warp is done with the stage that
    // slice kt + kStages - 1 goes into (it held slice kt - 1)
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = kt + kStages - 1;
    if (nxt < KT) load_stage(nxt % kStages, nxt);
    cp_async_commit();
    const __nv_bfloat16* As = smem + (kt % kStages) * kStageElems;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // A: lanes 0-15 address rows 0-15 at k 0-7, lanes 16-31 at k 8-15
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], As + swz(rb + i * 16 + (lane & 15), ks * 2 + (lane >> 4)));
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const __nv_bfloat16* Bs = As + BM * kBK + b * kBN * kBK;
#pragma unroll
        for (int jp = 0; jp < NI / 2; ++jp) {
          // two 8-column fragments a load: lanes 0-7 and 8-15 the k halves
          // of columns 0-7, lanes 16-31 those of columns 8-15
          uint32_t bf[4];
          ldmatrix_x4(bf, Bs + swz(nb + jp * 16 + (lane & 7) + ((lane >> 4) << 3),
                                   ks * 2 + ((lane >> 3) & 1)));
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_bf16(acc[b][i][2 * jp], af[i], bf[0], bf[1]);
            mma_bf16(acc[b][i][2 * jp + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // an accumulator fragment holds rows g and g + 8, columns 2t and 2t + 1
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rb + i * 16 + g + half * 8;
      if (r >= rows) continue;
      const long long p = m0 + r;
      if (kGated) {
        __nv_bfloat16* h = static_cast<__nv_bfloat16*>(out) + p * N + n0;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const float* gt = acc[0][i][j] + 2 * half;
          const float* up = acc[kB - 1][i][j] + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(h + nb + j * 8 + 2 * t) =
              __floats2bfloat162_rn(silu(gt[0]) * up[0], silu(gt[1]) * up[1]);
        }
      } else {
        const float w = pair_w[p];
        float* y = static_cast<float*>(out) + p * N + n0;
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          const float* v = acc[0][i][j] + 2 * half;
          *reinterpret_cast<float2*>(y + nb + j * 8 + 2 * t) = make_float2(v[0] * w, v[1] * w);
        }
      }
    }
}

template <int BM, bool kGated>
int launch(const void* a, const void* src, const void* offsets, const void* pair_w,
           const void* w0_r, const void* w1_r, const void* w0_s, const void* w1_s,
           int n_routed, int n_experts, int K, int N, int max_tiles, void* out, void* stream) {
  static mec::SmemGrant grant;
  constexpr int smem = kStages * (BM + (kGated ? 2 : 1) * kBN) * kBK * 2;
  auto kernel = grouped_expert_kernel<BM, kGated>;
  const int err = mec::grant_smem(kernel, smem, grant);
  if (err != 0) return err;
  const dim3 grid(max_tiles, N / kBN);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const int*>(src),
      static_cast<const int*>(offsets), static_cast<const float*>(pair_w),
      static_cast<const __nv_bfloat16*>(w0_r), static_cast<const __nv_bfloat16*>(w1_r),
      static_cast<const __nv_bfloat16*>(w0_s), static_cast<const __nv_bfloat16*>(w1_s), n_routed,
      n_experts, K, N, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (T, K) bf16 tokens; src: (P,) int32 token of each sorted pair;
// offsets: (n_experts + 1,) int32 sorted-row offsets of each expert;
// wg, wu: (n_routed, N, K) bf16; wg_s, wu_s: (S * N, K) bf16;
// h: (P, N) bf16. K % 64 == 0, N % 64 == 0, n_experts <= 255 (the
// wrapper checks);
// max_tiles covers the step's worst case, bm is 16 or 64.
extern "C" int mec_expert_gate_up(const void* x, const void* src, const void* offsets,
                                  const void* wg, const void* wu, const void* wg_s,
                                  const void* wu_s, int n_routed, int n_experts, int K, int N,
                                  int max_tiles, int bm, void* h, void* stream) {
  if (max_tiles == 0) return 0;
  return bm == 16 ? launch<16, true>(x, src, offsets, nullptr, wg, wu, wg_s, wu_s, n_routed,
                                     n_experts, K, N, max_tiles, h, stream)
                  : launch<64, true>(x, src, offsets, nullptr, wg, wu, wg_s, wu_s, n_routed,
                                     n_experts, K, N, max_tiles, h, stream);
}

// h: (P, K) bf16 in sorted order; pair_w: (P,) float32; wd: (n_routed,
// N, K) bf16; wd_s: (N, S * K) bf16; y: (P, N) float32.
extern "C" int mec_expert_down(const void* h, const void* offsets, const void* pair_w,
                               const void* wd, const void* wd_s, int n_routed, int n_experts,
                               int K, int N, int max_tiles, int bm, void* y, void* stream) {
  if (max_tiles == 0) return 0;
  return bm == 16 ? launch<16, false>(h, nullptr, offsets, pair_w, wd, nullptr, wd_s, nullptr,
                                      n_routed, n_experts, K, N, max_tiles, y, stream)
                  : launch<64, false>(h, nullptr, offsets, pair_w, wd, nullptr, wd_s, nullptr,
                                      n_routed, n_experts, K, N, max_tiles, y, stream);
}
