// K4 speech_dnn: the whole speech DNN forward with BatchNorm folded in,
// one block per tile of 8 rows.
//
// Replaces: mec_tpu/ops/pallas_kernels.py::make_speech_dnn_pallas (the
// closure `kernel`). Five Dense+ReLU blocks (inference BN folded into
// the Dense weights on the host, Keras eps 1e-3), the output Dense, a
// softmax over the classes, and one packed row per input:
// [probs (7) | penultimate (64) | zeros] across 128 columns, as
// pallas_kernels.py:319-330 writes it.
//
// What bounds it on this card: the weights, 56x512 + 512x512 + 512x256
// + 256x128 + 128x64 + 64x7 f32 = 1.85 MB, which every block reads once
// from L2; the arithmetic is 0.46 M FMAs per row. At serving batches
// (1..32) the launch and the L2 reads dominate, not the FMAs; the
// activations never leave the SM.
//
// Design: a block keeps its 8 rows' activations in shared memory (two
// 8 x 512 ping-pong buffers, 32 KB) and walks the layers; thread j
// computes output column j of a layer for all 8 rows, so the weight
// row W[k, :] is read coalesced once per block and each weight feeds 8
// FMAs. Products are fp32 FMAs (the parity contract is 1e-4; TF32 or
// bf16 would not hold it). Up to 8 layers of width <= 512 fit the
// fixed buffers; the host checks the shape before launching.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 8;
constexpr int kThreads = 512;
constexpr int kMaxWidth = 512;
constexpr int kMaxLayers = 8;
constexpr int kOutCols = 128;

struct DnnShape {
  int n_layers;                  // hidden layers + the output layer
  int dims[kMaxLayers + 1];      // dims[0] = input width, dims[n_layers] = classes
};

__global__ void __launch_bounds__(kThreads)
speech_dnn_kernel(const float* __restrict__ x, const float* __restrict__ params,
                  DnnShape shape, int B, float* __restrict__ out) {
  __shared__ float act[2][kTile][kMaxWidth];
  __shared__ float probs[kTile][kOutCols];
  const int row0 = blockIdx.x * kTile;
  const int nrows = min(kTile, B - row0);

  const int d0 = shape.dims[0];
  for (int i = threadIdx.x; i < kTile * d0; i += kThreads) {
    const int r = i / d0, k = i % d0;
    act[0][r][k] = r < nrows ? x[(size_t)(row0 + r) * d0 + k] : 0.f;
  }
  __syncthreads();

  // params: for each layer, W (din x dout, row-major) then b (dout)
  const float* p = params;
  int cur = 0;
  for (int L = 0; L < shape.n_layers; ++L) {
    const int din = shape.dims[L], dout = shape.dims[L + 1];
    const float* W = p;
    const float* bias = p + (size_t)din * dout;
    p = bias + dout;
    const bool relu = L + 1 < shape.n_layers;
    for (int j = threadIdx.x; j < dout; j += kThreads) {
      float acc[kTile];
      const float bj = bias[j];
#pragma unroll
      for (int r = 0; r < kTile; ++r) acc[r] = 0.f;
      for (int k = 0; k < din; ++k) {
        const float w = W[(size_t)k * dout + j];
#pragma unroll
        for (int r = 0; r < kTile; ++r) acc[r] = fmaf(act[cur][r][k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const float v = acc[r] + bj;
        act[cur ^ 1][r][j] = relu ? fmaxf(v, 0.f) : v;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  // act[cur] holds the logits, act[cur ^ 1] the penultimate activations
  const int n_cls = shape.dims[shape.n_layers];
  const int pen = min(shape.dims[shape.n_layers - 1], kOutCols - n_cls);
  if (threadIdx.x < nrows) {
    const float* z = act[cur][threadIdx.x];
    float mx = z[0];
    for (int c = 1; c < n_cls; ++c) mx = fmaxf(mx, z[c]);
    float s = 0.f;
    for (int c = 0; c < n_cls; ++c) {
      const float e = expf(z[c] - mx);
      probs[threadIdx.x][c] = e;
      s += e;
    }
    for (int c = 0; c < n_cls; ++c) probs[threadIdx.x][c] /= s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * kOutCols; i += kThreads) {
    const int r = i / kOutCols, c = i % kOutCols;
    float v = 0.f;
    if (c < n_cls) v = probs[r][c];
    else if (c - n_cls < pen) v = act[cur ^ 1][r][c - n_cls];
    out[(size_t)(row0 + r) * kOutCols + c] = v;
  }
}

}  // namespace

// dims: host array of n_layers + 1 widths. Returns cudaErrorInvalidValue
// for a shape the fixed shared-memory buffers cannot hold.
extern "C" int mec_speech_dnn(const float* x, const float* params, const int* dims,
                              int n_layers, int B, float* out, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers) return (int)cudaErrorInvalidValue;
  DnnShape shape;
  shape.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) {
    if (dims[i] < 1 || dims[i] > kMaxWidth) return (int)cudaErrorInvalidValue;
    shape.dims[i] = dims[i];
  }
  if (dims[n_layers] > kOutCols) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int blocks = (B + kTile - 1) / kTile;
  speech_dnn_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(x, params, shape, B, out);
  return (int)cudaGetLastError();
}
