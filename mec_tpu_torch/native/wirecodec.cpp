// Native wire-format encoders for the serving host path.
//
// The serving engine compresses host->device uploads (12-bit PCM audio,
// YUV 4:2:0 images — see mec_tpu/serving/wire.py for the format specs
// and the measured rationale). The numpy encoders cost ~158 ms per
// 32-batch (44 ms pcm12 + 113 ms yuv420) — more than the upload time
// they save on a healthy link — because each stage materializes
// float32 temporaries over millions of elements. These single-pass
// C++ loops run at memory bandwidth instead.
//
// Numerics: same float32 arithmetic and round-half-to-even as the numpy
// reference implementations (built with -ffp-contract=off so FMA
// contraction cannot reassociate the YUV dot products); tests/test_wire.py
// pins pcm12 cpp==numpy bitwise and yuv420 to <=1 code.
//
// Built on demand by mec_tpu/native/build.py (g++ -O3 -march=native);
// loaded via ctypes from mec_tpu/native/wirecodec.py.

#include <algorithm>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kQ12 = 2047.0f;

void pcm12_clip(const float* x, int64_t n, uint8_t* out, float* scale_out) {
    float m = 1e-6f;
    for (int64_t i = 0; i < n; ++i) m = std::max(m, std::fabs(x[i]));
    *scale_out = m;
    // Two passes so the quantizer auto-vectorizes (vdivps + vroundps
    // keep the numpy reference's bitwise semantics: the divide is NOT a
    // reciprocal multiply — that differs by 1 code whenever scale < 1 —
    // and vroundps is the same round-half-to-even as nearbyintf).
    std::vector<uint16_t> codes((size_t)n);
    uint16_t* c = codes.data();
    for (int64_t i = 0; i < n; ++i) {
        const float q = std::nearbyintf(x[i] / m * kQ12);
        c[i] = (uint16_t)(std::clamp(q, -kQ12, kQ12) + 2048.0f);
    }
    // two samples -> three bytes: [u0>>4, (u0&15)<<4 | u1>>8, u1&255]
    for (int64_t i = 0; i < n; i += 2) {
        const uint32_t u0 = c[i], u1 = c[i + 1];
        uint8_t* o = out + (i / 2) * 3;
        o[0] = (uint8_t)(u0 >> 4);
        o[1] = (uint8_t)(((u0 & 15u) << 4) | (u1 >> 8));
        o[2] = (uint8_t)(u1 & 255u);
    }
}

// BT.601 full-range, float32 to match mec_tpu/serving/wire.py
constexpr float kKR = 0.299f, kKG = 0.587f, kKB = 0.114f;
constexpr float kCU = 0.5f / (1.0f - kKB);
constexpr float kCV = 0.5f / (1.0f - kKR);

inline uint8_t q8(float v) {
    return (uint8_t)std::clamp(std::nearbyintf(v), 0.0f, 255.0f);
}

void yuv420_image(const uint8_t* rgb, int h, int w,
                  uint8_t* y_out, uint8_t* uv_out) {
    // Row-pair processing: a vectorizable full-row pass computes Y and
    // float U/V rows, then the 2x2 subsample reduces the two row
    // buffers. Mean matches numpy's reshape(...).mean(axis=(2,4)):
    // pairwise sum over the 2x2 cell, divided by 4.
    std::vector<float> ubuf((size_t)2 * w), vbuf((size_t)2 * w);
    for (int by = 0; by < h / 2; ++by) {
        for (int dy = 0; dy < 2; ++dy) {
            const int yy = 2 * by + dy;
            const uint8_t* row = rgb + (int64_t)yy * w * 3;
            uint8_t* yrow = y_out + (int64_t)yy * w;
            float* ur = &ubuf[(size_t)dy * w];
            float* vr = &vbuf[(size_t)dy * w];
            for (int xx = 0; xx < w; ++xx) {
                const float r = (float)row[3 * xx];
                const float g = (float)row[3 * xx + 1];
                const float b = (float)row[3 * xx + 2];
                const float y = kKR * r + kKG * g + kKB * b;
                yrow[xx] = q8(y);
                ur[xx] = (b - y) * kCU + 128.0f;
                vr[xx] = (r - y) * kCV + 128.0f;
            }
        }
        uint8_t* o = uv_out + (int64_t)by * (w / 2) * 2;
        for (int bx = 0; bx < w / 2; ++bx) {
            // numpy mean over a (2, 2) cell: (a+b) + (c+d), then /4
            const float u = ((ubuf[2 * bx] + ubuf[2 * bx + 1])
                             + (ubuf[w + 2 * bx] + ubuf[w + 2 * bx + 1]))
                            / 4.0f;
            const float v = ((vbuf[2 * bx] + vbuf[2 * bx + 1])
                             + (vbuf[w + 2 * bx] + vbuf[w + 2 * bx + 1]))
                            / 4.0f;
            o[2 * bx] = q8(u);
            o[2 * bx + 1] = q8(v);
        }
    }
}

template <typename Fn>
void for_clips(int b, Fn fn) {
    int nt = (int)std::min<unsigned>(std::max(1u,
        std::thread::hardware_concurrency()), (unsigned)b);
    if (nt <= 1) {
        for (int i = 0; i < b; ++i) fn(i);
        return;
    }
    std::vector<std::thread> ts;
    ts.reserve(nt);
    for (int t = 0; t < nt; ++t) {
        ts.emplace_back([=] {
            for (int i = t; i < b; i += nt) fn(i);
        });
    }
    for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// waves (b, n) float32, n even -> packed (b, 3n/2) uint8, scale (b) float32
void pcm12_encode(const float* waves, int b, int64_t n,
                  uint8_t* packed, float* scale) {
    std::fesetround(FE_TONEAREST);
    for_clips(b, [=](int i) {
        pcm12_clip(waves + (int64_t)i * n, n,
                   packed + (int64_t)i * (3 * n / 2), scale + i);
    });
}

// rgb (b, h, w, 3) uint8, h/w even -> y (b, h, w), uv (b, h/2, w/2, 2)
void yuv420_encode(const uint8_t* rgb, int b, int h, int w,
                   uint8_t* y_out, uint8_t* uv_out) {
    std::fesetround(FE_TONEAREST);
    const int64_t in_stride = (int64_t)h * w * 3;
    const int64_t y_stride = (int64_t)h * w;
    const int64_t uv_stride = (int64_t)(h / 2) * (w / 2) * 2;
    for_clips(b, [=](int i) {
        yuv420_image(rgb + i * in_stride, h, w,
                     y_out + i * y_stride, uv_out + i * uv_stride);
    });
}

}  // extern "C"
