// expert_routing: everything of one Moonlight-16B-A3B expert layer
// (deepseek_v3, noaux_tc routing with n_group = topk_group = 1) from the
// residual stream x to the residual stream x', except the grouped expert
// GEMM's two launches (grouped_expert_gemm.cu), in three launches:
//
//   router   h = RMSNorm(x) in bf16; s = sigmoid(h . Wg^T) in float32; a
//            token's k experts are the top k of s + bias (the bias chooses
//            and never weights), weighted s / sum(s) * scale
//   sort     a stable counting sort of the layer's token-expert pairs by
//            expert: ops/expert_gemm.py::route's Routing, and the step's
//            routing counters
//   combine  x' = x + bf16(the sum of a token's pairs of y, in slot order)
//
// Replaces no TPU kernel: the JAX package has no top-k expert decoder. It
// was added because the layer's glue, written as PyTorch operations, was
// 59 launches of tiny kernels a layer (the RMSNorm's casts and means, a
// float32 copy of the gate, topk, the stable argsort's radix passes, the
// scatters and the gathered sum), 1,534 a step in the replayed CUDA graph,
// each a few microseconds of device time and a gap behind it.
//
// What bounds it on this card (H100 SXM data sheet): at one request (16-128
// tokens) none of the three moves more than a few MB, so launch latency and
// the chain of dependent steps inside each bound it; at 32 requests of 128
// tokens the router's 4,096 x 64 x 2048 float32 FMAs (~18 us at the 67
// TFLOP/s float32 rate) and the combine's 8 float32 rows a token (256 MB)
// do. The routing stays float32 from bf16 inputs, with no tensor cores:
// they would add in another precision, and the choice of experts has to
// follow the float32 scores.
//
// Design. router: a block takes TB tokens (the wrapper picks TB from the
// step's tokens so that the grid covers the SMs once, ops/expert_gemm.py::
// router_tokens); a warp a token normalises it (the float32 mean of squares,
// rsqrt, round to bf16, times the bf16 weight: rms_norm's roundings) into
// shared memory and h; the 64 gate products are a register-tiled FMA
// product (4 tokens x 4 experts a thread, over every (64 / TB)-th 16-byte
// chunk of K, so that a warp's loads of the gate are whole lines; the
// partial sums added by a butterfly, a fixed order); a warp a token then
// takes the top k by k rounds of a warp argmax (ties to the lower index).
// sort: one block; a histogram, its exclusive scan (the offsets), then
// chunks of 1,024 pairs in their (token, slot) order, ranked within a
// warp by __match_any_sync and across warps by a scan of each expert's
// per-warp counts, so every pair's position is its expert's offset plus
// the pairs of that expert before it: route()'s stable argsort. No
// atomics outside the histogram's integer sums, so a replay repeats eager
// bit for bit. combine: a block a token, 8 columns a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "per_device.cuh"
#include "reduce.cuh"

namespace {

constexpr int kRouterThreads = 512;
constexpr int kExperts = 64;         // routed experts the router scores
constexpr int kRowChunks = 8;        // a lane's 16-byte chunks of a row: H <= 2048
constexpr int kBatch = 4;            // the gate's steps of 8 loaded together
constexpr int kMaxTopK = 8;
constexpr int kSortThreads = 1024;
constexpr int kMaxKeys = 256;        // experts (routed and shared) + the sentinel
constexpr int kCombineThreads = 256;
constexpr int kMaxPairs = 32;        // pairs a token: k routed + the shared

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 u = __bfloat1622float2(p[q]);
    f[2 * q] = u.x;
    f[2 * q + 1] = u.y;
  }
}

template <int TB>
__global__ void __launch_bounds__(kRouterThreads)
expert_router_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ norm_w,
                     const __nv_bfloat16* __restrict__ gate_w,
                     const __nv_bfloat16* __restrict__ bias, int T, int H, float eps, int k,
                     int norm_topk, float scale, __nv_bfloat16* __restrict__ h,
                     int* __restrict__ topk_idx, float* __restrict__ topk_w) {
  constexpr int kGroups = kRouterThreads / 16 / (TB / 4);   // threads a 4 x 4 tile
  constexpr int kWarps = kRouterThreads / 32;
  static_assert(TB % 4 == 0 && kGroups >= 1 && 32 % kGroups == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem_raw);          // (TB, H)
  float* score = reinterpret_cast<float*>(smem_raw + (size_t)TB * H * 2);  // (TB, 64)
  float* choice = score + TB * kExperts;                                  // (TB, 64)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = blockIdx.x * TB;
  const int chunks = H / 8;   // 16-byte chunks a row

  // the gate's rows into L2 while the norm runs: every block reads all
  // of them, and after the step's expert weights they are in none
  for (int i = tid; i < kExperts * H / 64; i += kRouterThreads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(gate_w + (size_t)i * 64));

  // ---- RMSNorm, a warp a token: h = w * bf16(x * rsqrt(mean(x^2) + eps)),
  // the row and the weight loaded at once (kRowChunks 16-byte chunks a lane)
  for (int tt = warp; tt < TB; tt += kWarps) {
    uint4* hrow = reinterpret_cast<uint4*>(hs + (size_t)tt * H);
    const int t = t0 + tt;
    if (t >= T) {
      for (int c = lane; c < chunks; c += 32) hrow[c] = make_uint4(0, 0, 0, 0);
      continue;
    }
    const uint4* xrow = reinterpret_cast<const uint4*>(x + (size_t)t * H);
    const uint4* wrow = reinterpret_cast<const uint4*>(norm_w);
    uint4 xv[kRowChunks], wv[kRowChunks];
#pragma unroll
    for (int i = 0; i < kRowChunks; ++i) {
      const int c = lane + 32 * i;
      xv[i] = c < chunks ? xrow[c] : make_uint4(0, 0, 0, 0);
      wv[i] = c < chunks ? wrow[c] : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kRowChunks; ++i) {
      float f[8];
      unpack8(xv[i], f);
#pragma unroll
      for (int q = 0; q < 8; ++q) ss = fmaf(f[q], f[q], ss);
    }
    ss = warp_sum_f(ss);
    // the mean, then + eps, each rounded (no FMA): torch's two kernels
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / (float)H), eps));
    uint4* hout = reinterpret_cast<uint4*>(h + (size_t)t * H);
#pragma unroll
    for (int i = 0; i < kRowChunks; ++i) {
      const int c = lane + 32 * i;
      if (c >= chunks) break;
      float f[8], w[8];
      unpack8(xv[i], f);
      unpack8(wv[i], w);
      uint4 o;
      __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // rms_norm rounds the normalised row to bf16, then scales it in bf16
        const float2 n = __bfloat1622float2(__floats2bfloat162_rn(f[2 * q] * r, f[2 * q + 1] * r));
        op[q] = __floats2bfloat162_rn(w[2 * q] * n.x, w[2 * q + 1] * n.y);
      }
      hout[c] = o;
      hrow[c] = o;
    }
  }
  __syncthreads();

  // ---- the gate: 4 tokens x 4 experts a thread over every kGroups-th
  // 16-byte chunk of K, so that the kGroups threads of a tile are
  // neighbouring lanes reading neighbouring chunks of a row
  {
    const int g = tid % kGroups;
    const int ee = (tid / kGroups) % 16;      // experts 4 ee .. 4 ee + 3
    const int tg = tid / (kGroups * 16);      // tokens 4 tg .. 4 tg + 3
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const __nv_bfloat16* hb = hs + (size_t)(4 * tg) * H;
    const __nv_bfloat16* wb = gate_w + (size_t)(4 * ee) * H;
    // kBatch chunks of each of the 4 rows in flight together, then their
    // products summed in order
    for (int c0 = g; c0 < chunks; c0 += kGroups * kBatch) {
      uint4 wq[kBatch][4];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int c = c0 + b * kGroups;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wq[b][e] = c < chunks ? __ldg(reinterpret_cast<const uint4*>(wb + (size_t)e * H) + c)
                                : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int c = c0 + b * kGroups;
        if (c >= chunks) break;
        float hv[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          unpack8(reinterpret_cast<const uint4*>(hb + (size_t)i * H)[c], hv[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float wv[8];
          unpack8(wq[b][e], wv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[i][e] = fmaf(hv[i][q], wv[q], acc[i][e]);
        }
      }
    }
    // the kGroups lanes' partial sums by a butterfly: a fixed order
#pragma unroll
    for (int off = kGroups / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
    if (g == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) score[(4 * tg + i) * kExperts + 4 * ee + e] = acc[i][e];
  }
  __syncthreads();
  // sigmoid of the logits in place, and the biased scores that choose
  for (int o = tid; o < TB * kExperts; o += kRouterThreads) {
    const float sc = 1.f / (1.f + expf(-score[o]));
    score[o] = sc;
    choice[o] = sc + __bfloat162float(bias[o % kExperts]);
  }
  __syncthreads();

  // ---- top k, a warp a token: lane l holds experts l and l + 32
  for (int tt = warp; tt < TB; tt += kWarps) {
    const int t = t0 + tt;
    if (t >= T) continue;
    float c0 = choice[tt * kExperts + lane], c1 = choice[tt * kExperts + lane + 32];
    int sel[kMaxTopK];
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j) {
      if (j >= k) break;
      // the larger of the lane's two (the lower index on a tie), then the
      // warp's largest by value, then by lower index
      float v = c0;
      int i = lane;
      if (c1 > c0) {
        v = c1;
        i = lane + 32;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        if (ov > v || (ov == v && oi < i)) {
          v = ov;
          i = oi;
        }
      }
      if (i == lane) c0 = -INFINITY;
      if (i == lane + 32) c1 = -INFINITY;
      sel[j] = i;
    }
    if (lane == 0) {
      const float* sc = score + tt * kExperts;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxTopK; ++j)
        if (j < k) sum += sc[sel[j]];
#pragma unroll
      for (int j = 0; j < kMaxTopK; ++j) {
        if (j >= k) break;
        const float s = sc[sel[j]];
        topk_idx[(size_t)t * k + j] = sel[j];
        topk_w[(size_t)t * k + j] = (norm_topk ? s / (sum + 1e-20f) : s) * scale;
      }
    }
  }
}

// a pair's expert: its routed expert, a shared one, or the sentinel
// (n_experts) for every pair of a padding token; both reads issued at once
__device__ __forceinline__ int pair_key(int f, int per, int k, int n_routed, int n_experts,
                                        const int* __restrict__ topk_idx,
                                        const unsigned char* __restrict__ valid, int& t, int& j) {
  t = f / per;
  j = f - t * per;
  const int routed = topk_idx[(size_t)t * k + min(j, k - 1)];
  if (!valid[t]) return n_experts;
  return j < k ? routed : n_routed + (j - k);
}

__global__ void __launch_bounds__(kSortThreads)
expert_sort_kernel(const int* __restrict__ topk_idx, const float* __restrict__ topk_w,
                   const unsigned char* __restrict__ valid, int T, int k, int n_routed,
                   int n_experts, int* __restrict__ counts, int* __restrict__ offsets,
                   int* __restrict__ src, float* __restrict__ weight, long long* __restrict__ pos,
                   int* __restrict__ counters) {
  __shared__ int hist[kMaxKeys];
  __shared__ int base[kMaxKeys];
  __shared__ int wcnt[kMaxKeys][32];   // [expert][warp] of one chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = k + n_experts - n_routed;
  const int P = T * per, keys = n_experts + 1;
  const unsigned below = (1u << lane) - 1;

  for (int e = tid; e < keys; e += kSortThreads) hist[e] = 0;
  __syncthreads();
  for (int f0 = 0; f0 < P; f0 += kSortThreads) {
    const int f = f0 + tid;
    int t, j;
    const int key = f < P ? pair_key(f, per, k, n_routed, n_experts, topk_idx, valid, t, j) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (peers & below) == 0) atomicAdd(&hist[key], __popc(peers));
  }
  __syncthreads();
  // counts, offsets (the exclusive scan) and the counters, by warp 0
  if (warp == 0) {
    int run = 0, touched = 0, routed = 0;
    for (int e0 = 0; e0 < keys; e0 += 32) {
      const int e = e0 + lane;
      const int c = e < keys ? hist[e] : 0;
      int incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      if (e < keys) {
        counts[e] = c;
        offsets[e] = base[e] = run + incl - c;
      }
      if (e < n_routed) {
        touched += c > 0;
        routed += c;
      }
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    touched = mec::warp_sum(touched);
    routed = mec::warp_sum(routed);
    if (lane == 0) {
      counters[0] += touched;
      counters[1] += routed;
    }
  }
  // every pair's position, a chunk of 1,024 pairs at a time in (token,
  // slot) order: its expert's next free row plus its rank among the
  // chunk's earlier pairs of that expert
  for (int f0 = 0; f0 < P; f0 += kSortThreads) {
    __syncthreads();
    for (int i = tid; i < keys * 32; i += kSortThreads) (&wcnt[0][0])[i] = 0;
    __syncthreads();
    const int f = f0 + tid;
    int t = 0, j = 0;
    const int key = f < P ? pair_key(f, per, k, n_routed, n_experts, topk_idx, valid, t, j) : -1;
    const float pw = f < P ? topk_w[(size_t)t * k + min(j, k - 1)] : 0.f;
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    const int rank = __popc(peers & below);
    if (key >= 0 && rank == 0) wcnt[key][warp] = __popc(peers);
    __syncthreads();
    for (int e = warp; e < keys; e += 32) {
      const int c = wcnt[e][lane];
      int incl = c;
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const int b = base[e];
      wcnt[e][lane] = b + incl - c;
      __syncwarp();
      if (lane == 31) base[e] = b + incl;
    }
    __syncthreads();
    if (key >= 0) {
      const int p = wcnt[key][warp] + rank;
      pos[f] = p;
      src[p] = t;
      weight[p] = j < k ? pw : 1.f;
    }
  }
}

__global__ void __launch_bounds__(kCombineThreads)
expert_combine_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ y,
                      const long long* __restrict__ pos, const unsigned char* __restrict__ valid,
                      int H, int per, __nv_bfloat16* __restrict__ out) {
  __shared__ long long rows[kMaxPairs];
  const int t = blockIdx.x;
  const bool real = valid[t] != 0;
  if (threadIdx.x < per) rows[threadIdx.x] = pos[(size_t)t * per + threadIdx.x];
  __syncthreads();
  const uint4* xrow = reinterpret_cast<const uint4*>(x + (size_t)t * H);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)t * H);
  for (int c = threadIdx.x; c < H / 8; c += kCombineThreads) {
    const uint4 xq = xrow[c];
    // a padding token's sum is 0 (combine's torch.where), then added as a
    // real one's is, so x + 0 rounds as it does there
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (real) {
      // eight pairs' rows loaded together, then added in slot order
      for (int j0 = 0; j0 < per; j0 += 8) {
        float4 a[8], b[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (j0 + q >= per) break;
          const float4* yr = reinterpret_cast<const float4*>(y + rows[j0 + q] * H) + 2 * c;
          a[q] = yr[0];
          b[q] = yr[1];
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (j0 + q >= per) break;
          const float v[8] = {a[q].x, a[q].y, a[q].z, a[q].w, b[q].x, b[q].y, b[q].z, b[q].w};
#pragma unroll
          for (int u = 0; u < 8; ++u) s[u] = j0 + q == 0 ? v[u] : s[u] + v[u];
        }
      }
    }
    float xf[8];
    unpack8(xq, xf);
    uint4 o;
    __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // the sum rounds to bf16 once, and x + it once more
      const float2 sb = __bfloat1622float2(__floats2bfloat162_rn(s[2 * q], s[2 * q + 1]));
      op[q] = __floats2bfloat162_rn(xf[2 * q] + sb.x, xf[2 * q + 1] + sb.y);
    }
    orow[c] = o;
  }
}

template <int TB>
int launch_router(const void* x, const void* norm_w, const void* gate_w, const void* bias, int T,
                  int H, float eps, int k, int norm_topk, float scale, void* h, void* topk_idx,
                  void* topk_w, void* stream) {
  static mec::SmemGrant grant;
  const int smem = TB * H * 2 + 2 * TB * kExperts * 4;
  auto kernel = expert_router_kernel<TB>;
  const int err = mec::grant_smem(kernel, smem, grant);
  if (err != 0) return err;
  kernel<<<(T + TB - 1) / TB, kRouterThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(norm_w),
      static_cast<const __nv_bfloat16*>(gate_w), static_cast<const __nv_bfloat16*>(bias), T, H,
      eps, k, norm_topk, scale, static_cast<__nv_bfloat16*>(h), static_cast<int*>(topk_idx),
      static_cast<float*>(topk_w));
  return (int)cudaGetLastError();
}

}  // namespace

// x: (T, H) bf16; norm_w: (H,) bf16; gate_w: (64, H) bf16; bias: (64,)
// bf16; h: (T, H) bf16; topk_idx: (T, k) int32; topk_w: (T, k) float32.
// H % 128 == 0, H <= 2048, 1 <= k <= 8, tb in {4, 8, 16, 32} and the shared memory
// within the card's (the wrapper checks).
extern "C" int mec_expert_router(const void* x, const void* norm_w, const void* gate_w,
                                 const void* bias, int T, int H, float eps, int k, int norm_topk,
                                 float scale, int tb, void* h, void* topk_idx, void* topk_w,
                                 void* stream) {
  if (T == 0) return 0;
  switch (tb) {
    case 4:
      return launch_router<4>(x, norm_w, gate_w, bias, T, H, eps, k, norm_topk, scale, h, topk_idx,
                              topk_w, stream);
    case 8:
      return launch_router<8>(x, norm_w, gate_w, bias, T, H, eps, k, norm_topk, scale, h, topk_idx,
                              topk_w, stream);
    case 16:
      return launch_router<16>(x, norm_w, gate_w, bias, T, H, eps, k, norm_topk, scale, h,
                               topk_idx, topk_w, stream);
    case 32:
      return launch_router<32>(x, norm_w, gate_w, bias, T, H, eps, k, norm_topk, scale, h,
                               topk_idx, topk_w, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// topk_idx: (T, k) int32; topk_w: (T, k) float32; valid: (T,) bool;
// counts, offsets: (n_experts + 1,) int32; src: (P,) int32; weight: (P,)
// float32; pos: (T, k + n_experts - n_routed) int64, P its size;
// counters: (2,) int32, added to. n_experts < 256, k + n_experts - n_routed
// <= 32 (the wrapper checks).
extern "C" int mec_expert_sort(const void* topk_idx, const void* topk_w, const void* valid, int T,
                               int k, int n_routed, int n_experts, void* counts, void* offsets,
                               void* src, void* weight, void* pos, void* counters, void* stream) {
  expert_sort_kernel<<<1, kSortThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(topk_idx), static_cast<const float*>(topk_w),
      static_cast<const unsigned char*>(valid), T, k, n_routed, n_experts,
      static_cast<int*>(counts), static_cast<int*>(offsets), static_cast<int*>(src),
      static_cast<float*>(weight), static_cast<long long*>(pos), static_cast<int*>(counters));
  return (int)cudaGetLastError();
}

// x: (T, H) bf16; y: (P, H) float32; pos: (T, per) int64; valid: (T,)
// bool; out: (T, H) bf16. H % 8 == 0, per <= 32 (the wrapper checks).
extern "C" int mec_expert_combine(const void* x, const void* y, const void* pos, const void* valid,
                                  int T, int H, int per, void* out, void* stream) {
  if (T == 0) return 0;
  expert_combine_kernel<<<T, kCombineThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(y),
      static_cast<const long long*>(pos), static_cast<const unsigned char*>(valid), H, per,
      static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
