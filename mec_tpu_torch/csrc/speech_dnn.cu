// K4 speech_dnn: the whole speech DNN forward with BatchNorm folded in,
// one thread block cluster per tile of 8 rows.
//
// Replaces: mec_tpu/ops/pallas_kernels.py::make_speech_dnn_pallas (the
// closure `kernel`). Five Dense+ReLU blocks (inference BN folded into
// the Dense weights on the host, Keras eps 1e-3), the output Dense, a
// softmax over the classes, and one packed row per input:
// [probs (7) | penultimate (64) | zeros] across 128 columns, as
// pallas_kernels.py:319-330 writes it.
//
// What bounds it on this card: by the data sheet the bytes, 1.85 MB of
// weights (56x512 + 512x512 + 512x256 + 256x128 + 128x64 + 64x7 f32)
// read once, 0.6 us. In practice neither bytes nor FMAs (0.46 M a row)
// but latency: six layers depend on each other, and every trip to L2
// (~1,000 clocks on this card, measured with clock64) and every barrier
// between blocks (~900 clocks) lies on the one chain. The design
// therefore spreads each layer over 16 SMs, takes the weights off the
// chain by copying them ahead of their use, and keeps every step of the
// chain itself in shared memory and registers.
//
// Design: a cluster of C blocks (16) owns a tile of 8 rows. Every block
// holds the whole tile's activations in shared memory, k-major
// (act[k][row], two ping-pong buffers), and computes dout / C output
// columns of each hidden layer.
//  * Weights: at its start the block asks cp.async for its column slice
//    of EVERY layer (142 KB of shared memory at full width; rows padded
//    by 4 floats against bank conflicts; each layer's bias slice behind
//    it), one cp.async group a layer, and each layer waits for its own
//    group only. So the trips to L2 leave the chain: only the first
//    layer waits for one.
//  * The host lays the plan (offsets, widths, shifts) into the kernel's
//    parameters and the layer loop is unrolled, so the chain holds no
//    integer division and no lookup.
//  * Products: a warp owns one 4-column x 4-row register tile and a
//    slab of K; its lanes take k = lane, lane + 32, ...: one 16-byte
//    weight load and one 16-byte activation load (both shared memory)
//    feed 16 fp32 FMAs. The narrow layers have fewer tiles than warps
//    and split K over more warps instead of idling.
//  * Sums: the 32 lanes' tiles are folded by shuffles (each step halves
//    the values a lane carries), the slabs of a tile meet in shared
//    memory and are added in slab order, then bias and ReLU. Every order
//    is fixed, so two runs give the same bits.
//  * Exchange: the block writes its columns into the next buffer of
//    EVERY block of the cluster through distributed shared memory, all
//    threads storing side by side; cluster.sync() ends the layer.
// The output layer and the softmax are small: the block of rank r takes
// the rows i with i % C == r, a warp a class. Batches above 8 rows take
// a cluster per 8 rows (B = 32: 64 blocks; every cluster reads the
// weights from L2 again, which costs less than the FMAs of a larger
// tile on the same 16 SMs). A layer that does not fit this scheme (a
// width that does not divide into a power of two of 4-column groups per
// block, unaligned weights, no room left in shared memory) takes a
// scalar path from global memory with the same exchange. Products are
// fp32 FMAs (the parity contract is 1e-4; TF32 or bf16 would not hold
// it). Up to 8 layers of width <= 512; the host checks the shape before
// launching.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "per_device.cuh"
#include "trace.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 8;                   // rows a cluster
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 512;
constexpr int kMaxLayers = 8;
constexpr int kOutCols = 128;
constexpr int kMaxCluster = 16;
constexpr int kPad = 4;                    // floats added to a staged weight row
constexpr int kWeightFloats = 40960;       // staged weights of all layers (160 KB)
constexpr int kMaxItems = 64;              // (tile, K slab) pairs a layer
constexpr int kActFloats = kMaxWidth * kRows;
constexpr int kSmemFloats = 2 * kActFloats + kWeightFloats + kMaxItems * 16  // act, weights, red
                            + kMaxItems * 16 + kOutCols;                       // vals, logits
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);

// How a cluster takes one layer; laid out by the host.
struct LayerPlan {
  int w_off;                     // W (din x dout, row-major; its bias follows) in params
  int din, dout;
  int slot;                      // where its staged copy lies in shared memory, or -1
  int cg_shift;                  // hidden, staged: log2 of the block's 4-column groups
  int ns_shift;                  // hidden, staged: log2 of the K slabs a register tile
};

struct DnnPlan {
  int n_layers;                  // hidden layers + the output layer
  LayerPlan layer[kMaxLayers];
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copy of a layer's weights. A hidden layer's copy holds this
// block's columns, [din][n_cols + kPad], then its bias slice; the output
// layer's holds W and b as they lie in the parameters.
__device__ __forceinline__ void stage_layer(const float* params, const LayerPlan& y, bool last,
                                            int rank, float* weights) {
  if (y.slot < 0) return;
  float* dst = weights + y.slot;
  const float* W = params + y.w_off;
  if (last) {
    for (int i = threadIdx.x; i < y.din * y.dout + y.dout; i += kThreads) cp_async4(dst + i, W + i);
    return;
  }
  const int cgroups = 1 << y.cg_shift, n_cols = 4 << y.cg_shift;
  const int stride = n_cols + kPad;
  const float* src = W + rank * n_cols;
  for (int i = threadIdx.x; i < (y.din << y.cg_shift); i += kThreads) {
    const int k = i >> y.cg_shift, c4 = i & (cgroups - 1);
    cp_async16(dst + k * stride + c4 * 4, src + (size_t)k * y.dout + c4 * 4);
  }
  const float* bias = W + (size_t)y.din * y.dout + rank * n_cols;
  for (int i = threadIdx.x; i < cgroups; i += kThreads)
    cp_async16(dst + y.din * stride + i * 4, bias + i * 4);
}

// One step of a sum over the warp that halves the values a lane carries:
// the lanes whose OFF bit is clear keep a[0..N), the others a[N..2N),
// and each adds what its partner held of the same values.
template <int N, int OFF>
__device__ __forceinline__ void fold(float (&a)[16], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? a[i] : a[i + N];
    const float keep = up ? a[i + N] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One hidden layer: cur (k-major, this block's copy) -> this block's
// columns of nxt in every block of the cluster. The caller has waited
// for the layer's staged weights and ends the layer with cluster.sync().
__device__ __forceinline__ void hidden_layer(cg::cluster_group& cluster, const float* params,
                                             const LayerPlan& y, const float* weights,
                                             const float* cur, float* nxt, float* red,
                                             float* vals) {
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (y.slot < 0) {
    // any width: one output a thread, the cluster's threads side by side
    const float* W = params + y.w_off;
    const float* bias = W + (size_t)y.din * y.dout;
    for (int i = rank * kThreads + tid; i < y.dout * kRows; i += C * kThreads) {
      const int j = i / kRows, r = i % kRows;
      float acc = 0.f;
      for (int k = 0; k < y.din; ++k) acc = fmaf(cur[k * kRows + r], W[(size_t)k * y.dout + j], acc);
      const float v = fmaxf(acc + bias[j], 0.f);
      for (int peer = 0; peer < C; ++peer) cluster.map_shared_rank(nxt, peer)[i] = v;
    }
    return;
  }
  const int cgroups = 1 << y.cg_shift, n_cols = 4 << y.cg_shift;
  const int stride = n_cols + kPad;
  const int NS = 1 << y.ns_shift;                  // K slabs a register tile
  const int items = (2 << y.cg_shift) << y.ns_shift;
  const float* slot = weights + y.slot;
  MEC_TRACE_MARK()   // the layer's weights have landed
  for (int item = warp; item < items; item += kWarps) {
    const int tile = item >> y.ns_shift, slab = item & (NS - 1);
    const float* Wc = slot + (tile & (cgroups - 1)) * 4;
    const float* Ar = cur + (tile >> y.cg_shift) * 4;
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int k = lane + 32 * slab; k < y.din; k += 32 * NS) {
      const float4 w = *reinterpret_cast<const float4*>(Wc + k * stride);
      const float4 a = *reinterpret_cast<const float4*>(Ar + k * kRows);
      const float wc[4] = {w.x, w.y, w.z, w.w};
      const float ar[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[c * 4 + r] = fmaf(ar[r], wc[c], acc[c * 4 + r]);
    }
    fold<8, 16>(acc, lane);
    fold<4, 8>(acc, lane);
    fold<2, 4>(acc, lane);
    fold<1, 2>(acc, lane);
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
    // bits 4..1 of the lane say which of the 16 values it ended with
    if ((lane & 1) == 0) red[item * 16 + ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                             ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1)] = acc[0];
  }
  MEC_TRACE_MARK()   // products and the fold
  __syncthreads();
  // add the slabs in slab order, then bias and ReLU
  const float* sbias = slot + y.din * stride;
  for (int o = tid; o < n_cols * kRows; o += kThreads) {
    const int col = o / kRows, r = o % kRows;
    const int tile = ((r / 4) << y.cg_shift) + col / 4;
    const float* part = red + ((tile << y.ns_shift) * 16) + (col % 4) * 4 + r % 4;
    float v = part[0];
    for (int s = 1; s < NS; ++s) v += part[s * 16];
    vals[o] = fmaxf(v + sbias[col], 0.f);
  }
  MEC_TRACE_MARK()   // slabs, bias, ReLU
  __syncthreads();
  // the block's columns are one run of the k-major buffer: hand it to
  // every block of the cluster, all threads side by side
  const int n4_shift = y.cg_shift + 3;             // n_cols * kRows / 4 float4s
  const float4* vals4 = reinterpret_cast<const float4*>(vals);
  for (int i = tid; i < (C << n4_shift); i += kThreads) {
    const int peer = i >> n4_shift, q = i & ((1 << n4_shift) - 1);
    reinterpret_cast<float4*>(cluster.map_shared_rank(nxt, peer))[(rank << n4_shift) + q] = vals4[q];
  }
}

// The output layer, the softmax and the packed rows: this block takes
// the rows r with r % C == rank.
__device__ __forceinline__ void output_layer(const float* params, const LayerPlan& y,
                                             const float* weights, const float* cur,
                                             float* logits, int C, int rank, int row0, int nrows,
                                             float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_cls = y.dout;
  const int pen = min(y.din, kOutCols - n_cls);
  const float* W = y.slot >= 0 ? weights + y.slot : params + y.w_off;
  const float* bias = W + y.din * n_cls;
  for (int r = rank; r < nrows; r += C) {
    for (int c = warp; c < n_cls; c += kWarps) {
      float acc = 0.f;
      for (int k = lane; k < y.din; k += 32) acc = fmaf(cur[k * kRows + r], W[k * n_cls + c], acc);
      acc = warp_sum(acc);
      if (lane == 0) logits[c] = acc + bias[c];
    }
    __syncthreads();
    if (warp == 0) {
      float mx = -INFINITY;
      for (int c = lane; c < n_cls; c += 32) mx = fmaxf(mx, logits[c]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int c = lane; c < n_cls; c += 32) {
        const float e = expf(logits[c] - mx);
        logits[c] = e;
        s += e;
      }
      s = warp_sum(s);
      for (int c = lane; c < n_cls; c += 32) logits[c] /= s;
    }
    __syncthreads();
    for (int c = tid; c < kOutCols; c += kThreads) {
      float v = 0.f;
      if (c < n_cls) v = logits[c];
      else if (c - n_cls < pen) v = cur[(c - n_cls) * kRows + r];
      out[(size_t)(row0 + r) * kOutCols + c] = v;
    }
    __syncthreads();
  }
}

// Layers L, L + 1, ... of the plan. A template, not a loop: the wait for
// a layer's cp.async group takes the number of groups behind it as an
// immediate, and the plan is read at fixed offsets of the parameters.
template <int L>
__device__ __forceinline__ void run_layers(cg::cluster_group& cluster, const float* params,
                                           const DnnPlan& plan, float* act, const float* weights,
                                           float* red, float* vals, float* logits, int row0,
                                           int nrows, float* out) {
  if constexpr (L < kMaxLayers) {
    float* cur = act + (L & 1) * kActFloats;
    float* nxt = act + ((L + 1) & 1) * kActFloats;
    cp_async_wait<kMaxLayers - 1 - L>();             // this layer's copy has landed
    __syncthreads();
    if (L + 1 < plan.n_layers) {
      hidden_layer(cluster, params, plan.layer[L], weights, cur, nxt, red, vals);
      // the layer's columns have arrived everywhere, and nobody still
      // reads the buffer that the next layer overwrites
      MEC_TRACE_MARK() // the exchange is issued
      cluster.sync();
      MEC_TRACE_MARK() // the cluster has met
      run_layers<L + 1>(cluster, params, plan, act, weights, red, vals, logits, row0, nrows, out);
    } else {
      // cur holds the penultimate activations; no block touches another's
      // shared memory from here on
      MEC_TRACE_MARK()
      output_layer(params, plan.layer[L], weights, cur, logits, (int)cluster.num_blocks(),
                   (int)cluster.block_rank(), row0, nrows, out);
      MEC_TRACE_MARK() // the output layer, softmax and packed rows
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
speech_dnn_kernel(const float* __restrict__ x, const float* __restrict__ params,
                  const DnnPlan plan, int B, float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int row0 = (blockIdx.x / C) * kRows;
  const int nrows = min(kRows, B - row0);

  MEC_TRACE_BEGIN()
  MEC_TRACE_MARK()
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                                 // 2 x act[k][row]
  float* weights = act + 2 * kActFloats;
  float* red = weights + kWeightFloats;              // (item, 16): the slabs' tiles
  float* vals = red + kMaxItems * 16;                // this block's columns, [col][row]
  float* logits = vals + kMaxItems * 16;             // kOutCols

  // the input rows, transposed, and every layer's weights: one cp.async
  // group a layer (an empty one past the last), the input with the first
  const int d0 = plan.layer[0].din;
  for (int i = tid; i < kRows * d0; i += kThreads) {
    const int r = i / d0, k = i % d0;
    if (r < nrows) cp_async4(act + k * kRows + r, x + (size_t)(row0 + r) * d0 + k);
    else act[k * kRows + r] = 0.f;
  }
#pragma unroll
  for (int L = 0; L < kMaxLayers; ++L) {
    if (L < plan.n_layers) stage_layer(params, plan.layer[L], L + 1 == plan.n_layers, rank, weights);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  MEC_TRACE_MARK()     // every copy is asked for
  // every block of the cluster is running before anyone writes into it
  cluster.sync();
  MEC_TRACE_MARK()

  run_layers<0>(cluster, params, plan, act, weights, red, vals, logits, row0, nrows, out);
}

// the kernel's attributes, set at the first launch on each device
cudaError_t configure() {
  static mec::SmemGrant grant;
  return (cudaError_t)mec::grant_smem(speech_dnn_kernel, kSmemBytes, grant, true);
}

// log2 of n when n is a power of two, else -1
int log2_exact(int n) {
  int s = 0;
  while ((1 << s) < n) ++s;
  return (1 << s) == n ? s : -1;
}

}  // namespace

// dims: host array of n_layers + 1 widths. cluster: blocks a cluster,
// 1..16; a cluster takes 8 rows. Returns cudaErrorInvalidValue for a shape the fixed
// shared-memory buffers cannot hold, and the launch's own error when the
// card refuses the cluster.
extern "C" int mec_speech_dnn(const float* x, const float* params, const int* dims,
                              int n_layers, int B, int cluster, float* out, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= n_layers; ++i)
    if (dims[i] < 1 || dims[i] > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (dims[n_layers] > kOutCols) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;

  // the plan: which layers are staged in shared memory, and where
  DnnPlan plan;
  plan.n_layers = n_layers;
  int w_off = 0, used = 0;
  for (int L = 0; L < n_layers; ++L) {
    LayerPlan& y = plan.layer[L];
    y.w_off = w_off;
    y.din = dims[L];
    y.dout = dims[L + 1];
    y.slot = -1;
    y.cg_shift = y.ns_shift = 0;
    w_off += y.din * y.dout + y.dout;
    int need;
    if (L + 1 < n_layers) {
      const int cgroups = y.dout / (4 * cluster);
      const int cg_shift = log2_exact(cgroups);
      const bool aligned = (reinterpret_cast<uintptr_t>(params + y.w_off) & 15) == 0;
      if (y.dout % (4 * cluster) || cg_shift < 0 || 2 * cgroups > kMaxItems || !aligned) continue;
      y.cg_shift = cg_shift;
      y.ns_shift = 2 * cgroups >= kWarps ? 0 : log2_exact(kWarps / (2 * cgroups));
      need = y.din * (4 * cgroups + kPad) + 4 * cgroups;
    } else {
      need = (y.din * y.dout + y.dout + 3) & ~3;
    }
    if (used + need <= kWeightFloats) {
      y.slot = used;
      used += need;
    }
  }

  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((B + kRows - 1) / kRows * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, speech_dnn_kernel, x, params, plan, B, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
