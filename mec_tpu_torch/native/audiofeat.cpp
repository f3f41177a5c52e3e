// Native 56-dim audio feature frontend for the serving host path.
//
// Serving (bf16) mode ships the 56 float32 features over the
// host->device link instead of the waveform: 224 B/clip vs ~99 KB for
// packed 12-bit PCM (see mec_tpu/serving/wire.py) on a link that meters
// end-to-end throughput. This file computes the same features as the
// traced TPU frontend (mec_tpu/ops/audio_features.py, itself pinned to
// librosa semantics from reference preprocessing/audio_preprocessing.py)
// in a single pass per clip:
//
//   frame(center, hann) -> rFFT(2048) -> power spectrogram
//     -> sparse Slaney-mel matvec -> power_to_db -> DCT-II  (40 MFCC)
//     -> piptrack tuning estimate -> chroma filterbank       (12 chroma)
//     -> centroid / rolloff / zcr / rms                      (4 scalars)
//
// All constant operators (hann window, mel filterbank, DCT matrix, FFT
// bin frequencies, chroma base bins) are passed in from Python at init
// (mec_tpu/native/featurizer.py) so they are bit-identical to the ones
// the device frontend bakes into its graph; the numpy mirror
// (mec_tpu/ops/host_features.py) is the reference implementation and
// fallback, pinned against this code in tests/test_host_features.py.
//
// The rFFT runs as a 1024-point complex radix-2 FFT over packed
// even/odd samples with a split post-pass — float32 data, double-
// precision twiddle generation. Accumulations (mel, centroid, rms,
// chroma) use double accumulators; differences vs the float32 device
// frontend stay ~1e-3 absolute on MFCC/dB scales, inside the error the
// 12-bit PCM wire already introduced.
//
// Built on demand by mec_tpu/native/build.py (g++ -O3 -march=native).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Tables {
    int n_fft = 0, hop = 0, n_samples = 0, n_mels = 0, n_mfcc = 0;
    int n_bins = 0, n_frames = 0, half = 0;
    std::vector<float> hann;          // (n_fft)
    std::vector<float> dct;           // (n_mfcc, n_mels)
    std::vector<float> freqs;         // (n_bins)
    std::vector<float> chroma_base;   // (n_bins - 1)
    // sparse mel rows
    std::vector<int> mel_start, mel_len;
    std::vector<float> mel_w;         // concatenated row weights
    std::vector<int> mel_off;         // row offsets into mel_w
    // FFT tables (half = n_fft / 2 complex points). Stockham autosort:
    // one contiguous twiddle array per stage (l = half/2 .. 1 entries),
    // so every inner loop is unit-stride and auto-vectorizes.
    std::vector<std::vector<float>> st_re, st_im;
    std::vector<float> sp_re, sp_im;  // (n_bins) split twiddles, e^{-2pi i j/n_fft}
    // piptrack band
    int band_lo = 0, band_hi = 0;
    float sr = 22050.0f;
};

Tables g;

void build_fft_tables() {
    const int half = g.half;
    g.st_re.clear();
    g.st_im.clear();
    for (int l = half / 2; l >= 1; l >>= 1) {
        std::vector<float> re(l), im(l);
        for (int j = 0; j < l; ++j) {
            double a = -2.0 * M_PI * j / (2.0 * l);
            re[j] = (float)std::cos(a);
            im[j] = (float)std::sin(a);
        }
        g.st_re.push_back(std::move(re));
        g.st_im.push_back(std::move(im));
    }
    g.sp_re.assign(g.n_bins, 0.f);
    g.sp_im.assign(g.n_bins, 0.f);
    for (int j = 0; j < g.n_bins; ++j) {
        double a = -2.0 * M_PI * j / g.n_fft;
        g.sp_re[j] = (float)std::cos(a);
        g.sp_im[j] = (float)std::sin(a);
    }
}

// Stockham autosort radix-2 DIF FFT over `half` complex points.
// Natural order in and out; `wr`/`wi` are ping-pong scratch (size half).
// Result lands back in re/im when log2(half) is even (copied otherwise).
void fft_half(float* re, float* im, float* wr, float* wi) {
    const int half = g.half;
    float *xr = re, *xi = im, *yr = wr, *yi = wi;
    int m = 1, s = 0;
    for (int l = half / 2; l >= 1; l >>= 1, m <<= 1, ++s) {
        const float* twr = g.st_re[s].data();
        const float* twi = g.st_im[s].data();
        for (int j = 0; j < l; ++j) {
            const float cr = twr[j], ci = twi[j];
            const float* ar = xr + (size_t)j * m;
            const float* ai = xi + (size_t)j * m;
            const float* br = ar + (size_t)l * m;
            const float* bi = ai + (size_t)l * m;
            float* o0r = yr + (size_t)2 * j * m;
            float* o0i = yi + (size_t)2 * j * m;
            float* o1r = o0r + m;
            float* o1i = o0i + m;
            for (int k = 0; k < m; ++k) {
                const float dr = ar[k] - br[k];
                const float di = ai[k] - bi[k];
                o0r[k] = ar[k] + br[k];
                o0i[k] = ai[k] + bi[k];
                o1r[k] = cr * dr - ci * di;
                o1i[k] = cr * di + ci * dr;
            }
        }
        std::swap(xr, yr);
        std::swap(xi, yi);
    }
    if (xr != re) {
        std::memcpy(re, xr, sizeof(float) * half);
        std::memcpy(im, xi, sizeof(float) * half);
    }
}

// Windowed real frame (n_fft) -> power spectrum + magnitude (n_bins).
void rfft_power(const float* frame, float* power, float* mag,
                float* zre, float* zim, float* sr1, float* sr2) {
    const int half = g.half;
    for (int k = 0; k < half; ++k) {
        zre[k] = frame[2 * k];
        zim[k] = frame[2 * k + 1];
    }
    fft_half(zre, zim, sr1, sr2);
    // Unpack: X[j] = E[j] + W^j O[j], E/O from Z[j] and conj(Z[half-j]).
    for (int j = 0; j <= half; ++j) {
        const int j2 = (half - j) & (half - 1);  // half-j mod half
        const float ar = (j == half) ? zre[0] : zre[j];
        const float ai = (j == half) ? zim[0] : zim[j];
        const float br = zre[j2], bi = -zim[j2];
        const float er = 0.5f * (ar + br), ei = 0.5f * (ai + bi);
        // O = (Z - conj(Zr)) / (2i) = (d_i - i d_r) / 2 with d = Z - conj(Zr)
        const float dr = ar - br, di = ai - bi;
        const float or_ = 0.5f * di, oi = -0.5f * dr;
        const float xr = er + g.sp_re[j] * or_ - g.sp_im[j] * oi;
        const float xi = ei + g.sp_re[j] * oi + g.sp_im[j] * or_;
        const float p = xr * xr + xi * xi;
        power[j] = p;
        mag[j] = std::sqrt(p);
    }
}

inline double median_inplace(std::vector<float>& v) {
    if (v.empty()) return 0.0;
    const size_t n = v.size();
    const size_t hi = n / 2;
    std::nth_element(v.begin(), v.begin() + hi, v.end());
    float b = v[hi];
    if (n & 1) return b;
    float a = *std::max_element(v.begin(), v.begin() + hi);
    return 0.5 * ((double)a + (double)b);  // np.median: mean of middle two
}

void extract_clip(const float* y, float* out) {
    const int T = g.n_frames, F = g.n_bins, NF = g.n_fft, H = g.hop;
    const int M = g.n_mels, C = g.n_mfcc;
    const int pad = NF / 2;

    std::vector<float> power((size_t)T * F);
    std::vector<float> melspec((size_t)T * M);
    std::vector<float> frame(NF), mag(F);
    std::vector<float> zre(g.half), zim(g.half), sr1(g.half), sr2(g.half);
    // piptrack candidates, collected per frame inside the band
    std::vector<float> cand_pitch, cand_mag;
    cand_pitch.reserve((size_t)T * (g.band_hi - g.band_lo));
    cand_mag.reserve((size_t)T * (g.band_hi - g.band_lo));

    double centroid_sum = 0.0, rolloff_sum = 0.0, rms_sum = 0.0;
    double zcr_sum = 0.0;
    const float tinyf = 1.17549435e-38f;  // FLT_MIN, matches _TINY32

    // ---- zcr + rms via prefix sums over the (padded) signal ----
    // rms: zero-padded center frames -> windowed sums of y^2 are prefix
    // differences. zcr: crossings of the edge-padded signal between
    // consecutive samples; a frame's count is the prefix difference over
    // its 2047 interior comparisons (the first slot never counts,
    // matching librosa's zero_crossings pad=True).
    {
        std::vector<double> ps((size_t)g.n_samples + 1, 0.0);
        for (int s = 0; s < g.n_samples; ++s)
            ps[s + 1] = ps[s] + (double)y[s] * y[s];
        const int padded_n = g.n_samples + 2 * pad;
        // neg flag per padded sample (edge padding = constant edges)
        std::vector<uint8_t> negf((size_t)padded_n);
        {
            const float e0 = y[0], eN = y[g.n_samples - 1];
            const uint8_t n0 =
                (std::fabs(e0) <= 1e-10f) ? 0 : std::signbit(e0);
            const uint8_t nN =
                (std::fabs(eN) <= 1e-10f) ? 0 : std::signbit(eN);
            std::memset(negf.data(), n0, pad);
            for (int s = 0; s < g.n_samples; ++s) {
                const float ev = y[s];
                negf[pad + s] =
                    (std::fabs(ev) <= 1e-10f) ? 0 : (uint8_t)std::signbit(ev);
            }
            std::memset(negf.data() + pad + g.n_samples, nN, pad);
        }
        std::vector<int> pc((size_t)padded_n, 0);  // pc[s] = crossings <= s
        for (int s = 1; s < padded_n; ++s)
            pc[s] = pc[s - 1] + (negf[s] != negf[s - 1]);
        for (int t = 0; t < T; ++t) {
            const int start = t * H - pad;  // signal coords, zero pad
            const int lo = std::max(start, 0);
            const int hi = std::min(start + NF, g.n_samples);
            const double sq = (hi > lo) ? ps[hi] - ps[lo] : 0.0;
            rms_sum += std::sqrt(sq / NF);
            // padded coords: frame t spans [t*H, t*H + NF)
            const int p0 = t * H, p1 = std::min(t * H + NF, padded_n) - 1;
            zcr_sum += (double)(pc[p1] - pc[p0]) / NF;
        }
    }

    for (int t = 0; t < T; ++t) {
        const int start = t * H - pad;
        const int i0 = std::max(0, -start);
        const int i1 = std::min(NF, g.n_samples - start);
        if (i0 > 0) std::memset(frame.data(), 0, sizeof(float) * i0);
        if (i1 < NF)
            std::memset(frame.data() + std::max(i1, 0), 0,
                        sizeof(float) * (NF - std::max(i1, 0)));
        const float* yy = y + start;
        for (int i = i0; i < i1; ++i) frame[i] = yy[i] * g.hann[i];
        float* P = &power[(size_t)t * F];
        rfft_power(frame.data(), P, mag.data(), zre.data(), zim.data(),
                   sr1.data(), sr2.data());

        // ---- mel (sparse rows, double accumulate) ----
        float* mel = &melspec[(size_t)t * M];
        for (int m = 0; m < M; ++m) {
            const float* w = &g.mel_w[g.mel_off[m]];
            const int s0 = g.mel_start[m], L = g.mel_len[m];
            double acc = 0.0;
            for (int i = 0; i < L; ++i) acc += (double)w[i] * P[s0 + i];
            mel[m] = (float)acc;
        }

        // ---- spectral centroid / rolloff on |S| ----
        // one fused pass; sum(freqs * mag) / total == the traced
        // frontend's sum(freqs * (mag / total)) within float tolerance
        double total = 0.0, wsum = 0.0;
        for (int j = 0; j < F; ++j) {
            total += mag[j];
            wsum += (double)g.freqs[j] * mag[j];
        }
        const double tdiv = (total < (double)tinyf) ? 1.0 : total;
        centroid_sum += wsum / tdiv;
        // rolloff: first bin where float32 cumsum >= 0.85 * cumsum[-1]
        float csum = 0.0f;
        std::vector<float>& cum = frame;  // reuse scratch (size NF >= F)
        for (int j = 0; j < F; ++j) { csum += mag[j]; cum[j] = csum; }
        const float thresh = 0.85f * csum;
        int hit = F - 1;
        for (int j = 0; j < F; ++j) {
            if (cum[j] >= thresh) { hit = j; break; }
        }
        rolloff_sum += g.freqs[hit];

        // ---- piptrack candidates (band bins only) ----
        // threshold = 0.1 * frame max of power
        float fmax = 0.0f;
        for (int j = 0; j < F; ++j) fmax = std::max(fmax, P[j]);
        const float ref = 0.1f * fmax;
        for (int j = g.band_lo; j < g.band_hi; ++j) {
            // masked spectrogram values (zero unless above threshold)
            const float sj = (P[j] > ref) ? P[j] : 0.0f;
            const float sl =
                (j >= 1 && P[j - 1] > ref) ? P[j - 1] : 0.0f;
            const float sr_ =
                (j + 1 < F && P[j + 1] > ref) ? P[j + 1] : 0.0f;
            const float left = (j == 0) ? sj : sl;
            const float right = (j == F - 1) ? sj : sr_;
            if (!(sj > left && sj >= right)) continue;  // localmax
            // parabolic interpolation on the raw power row
            float shift = 0.0f, dskew = 0.0f;
            if (j >= 1 && j < F - 1) {
                const float avg = 0.5f * (P[j + 1] - P[j - 1]);
                const float den = 2.0f * P[j] - P[j + 1] - P[j - 1];
                shift = avg / (den + ((std::fabs(den) < tinyf) ? 1.0f : 0.0f));
                dskew = 0.5f * avg * shift;
            }
            const float pitch = ((float)j + shift) * g.sr / (float)NF;
            if (pitch > 0.0f) {
                cand_pitch.push_back(pitch);
                cand_mag.push_back(P[j] + dskew);
            }
        }

    }

    // ---- MFCC: power_to_db then time-mean then DCT (mean & DCT commute) --
    float db_max = -1e30f;
    for (size_t i = 0; i < melspec.size(); ++i) {
        const float v = 10.0f * std::log10(std::max(1e-10f, melspec[i]));
        melspec[i] = v;
        db_max = std::max(db_max, v);
    }
    const float db_floor = db_max - 80.0f;
    std::vector<double> mel_mean(M, 0.0);
    for (int t = 0; t < T; ++t)
        for (int m = 0; m < M; ++m)
            mel_mean[m] += std::max(melspec[(size_t)t * M + m], db_floor);
    for (int m = 0; m < M; ++m) mel_mean[m] /= T;
    for (int c = 0; c < C; ++c) {
        double acc = 0.0;
        for (int m = 0; m < M; ++m)
            acc += (double)g.dct[(size_t)c * M + m] * mel_mean[m];
        out[c] = (float)acc;
    }

    // ---- tuning estimate ----
    float tuning = 0.0f;
    if (!cand_mag.empty()) {
        std::vector<float> mags_copy(cand_mag);
        const double med = median_inplace(mags_copy);
        int counts[100] = {0};
        bool any = false;
        for (size_t i = 0; i < cand_mag.size(); ++i) {
            if (!((double)cand_mag[i] >= med)) continue;
            any = true;
            const float octs = std::log2(cand_pitch[i] / 27.5f);
            float r = std::fmod(12.0f * octs, 1.0f);
            if (r < 0.0f) r += 1.0f;          // np.mod semantics
            if (r >= 0.5f) r -= 1.0f;         // fold to [-0.5, 0.5)
            // np.histogram with float64 edges linspace(-0.5, 0.5, 101)
            int idx = (int)std::floor(((double)r + 0.5) * 100.0);
            idx = std::min(std::max(idx, 0), 99);
            const double lo_e = idx * 0.01 - 0.5;
            const double hi_e = (idx + 1) * 0.01 - 0.5;
            if ((double)r < lo_e) --idx;
            else if ((double)r >= hi_e && idx < 99) ++idx;
            ++counts[idx];
        }
        if (any) {
            int best = 0;
            for (int i = 1; i < 100; ++i)
                if (counts[i] > counts[best]) best = i;
            tuning = (float)(best * 0.01 - 0.5);
        }
    }

    // ---- chroma filterbank (synthesized per clip from the tuning) ----
    // Mirrors mec_tpu/ops/host_features.py::_chroma_filterbank.
    const int NC = 12;
    std::vector<float> frq(F), width(F);
    frq[0] = (g.chroma_base[0] - tuning) - 1.5f * NC;  // DC stand-in
    for (int j = 1; j < F; ++j) frq[j] = g.chroma_base[j - 1] - tuning;
    for (int j = 0; j < F - 1; ++j)
        width[j] = std::max(frq[j + 1] - frq[j], 1.0f);
    width[F - 1] = 1.0f;

    // fb stored transposed (F, 12): the per-frame accumulation then has
    // 12 independent accumulators over contiguous rows — vectorizes
    // without needing reduction reassociation.
    std::vector<float> fbT((size_t)F * NC);
    for (int j = 0; j < F; ++j) {
        const float oct_w = std::exp(
            -0.5f * ((frq[j] / NC - 5.0f) / 2.0f) * ((frq[j] / NC - 5.0f) / 2.0f));
        float col[12];
        double norm2 = 0.0;
        for (int c = 0; c < NC; ++c) {
            // D = remainder(frq - c + 6 + 120, 12) - 6
            float d = std::fmod(frq[j] - (float)c + 6.0f + 120.0f, 12.0f);
            if (d < 0.0f) d += 12.0f;  // np.remainder
            d -= 6.0f;
            const float w = std::exp(-0.5f * (2.0f * d / width[j]) * (2.0f * d / width[j]));
            col[c] = w;
            norm2 += (double)w * w;
        }
        const float norm = (float)std::sqrt(norm2);
        const float inv = (norm < tinyf) ? 1.0f : norm;
        for (int c = 0; c < NC; ++c) {
            // base_c rotation: chroma row (c - 3) mod 12 <- col[c]
            const int cr = (c + NC - 3) % NC;
            fbT[(size_t)j * NC + cr] = col[c] / inv * oct_w;
        }
    }
    double chroma_acc[12] = {0.0};
    for (int t = 0; t < T; ++t) {
        const float* P = &power[(size_t)t * F];
        float raw[12] = {0.f};  // 12 parallel accumulators, vectorizable
        for (int j = 0; j < F; ++j) {
            const float p = P[j];
            const float* w = &fbT[(size_t)j * NC];
            for (int c = 0; c < NC; ++c) raw[c] += w[c] * p;
        }
        float peak = 0.0f;
        for (int c = 0; c < NC; ++c) peak = std::max(peak, std::fabs(raw[c]));
        const float inv = (peak < tinyf) ? 1.0f : peak;
        for (int c = 0; c < NC; ++c) chroma_acc[c] += raw[c] / inv;
    }
    for (int c = 0; c < NC; ++c) out[40 + c] = (float)(chroma_acc[c] / T);

    out[52] = (float)(zcr_sum / T);
    out[53] = (float)(centroid_sum / T);
    out[54] = (float)(rolloff_sum / T);
    out[55] = (float)(rms_sum / T);
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

// Install the constant operators (computed by mec_tpu/ops/filters.py so
// they are bit-identical to the device frontend's). mel_fb is dense
// (n_mels, n_bins) row-major; sparsified here. chroma_base is float32
// (n_bins - 1). Returns 0 on success.
int audiofeat_init(int n_fft, int hop, int n_samples, int n_mels,
                   int n_mfcc, float sr,
                   const float* hann, const float* mel_fb,
                   const float* dct, const float* freqs,
                   const float* chroma_base,
                   float band_fmin, float band_fmax) {
    if (n_fft & (n_fft - 1)) return 1;  // power of two required
    g.n_fft = n_fft; g.hop = hop; g.n_samples = n_samples;
    g.n_mels = n_mels; g.n_mfcc = n_mfcc; g.sr = sr;
    g.n_bins = 1 + n_fft / 2;
    g.n_frames = 1 + n_samples / hop;
    g.half = n_fft / 2;
    g.hann.assign(hann, hann + n_fft);
    g.dct.assign(dct, dct + (size_t)n_mfcc * n_mels);
    g.freqs.assign(freqs, freqs + g.n_bins);
    g.chroma_base.assign(chroma_base, chroma_base + g.n_bins - 1);
    g.mel_start.assign(n_mels, 0);
    g.mel_len.assign(n_mels, 0);
    g.mel_off.assign(n_mels, 0);
    g.mel_w.clear();
    for (int m = 0; m < n_mels; ++m) {
        const float* row = mel_fb + (size_t)m * g.n_bins;
        int s = 0, e = g.n_bins;
        while (s < g.n_bins && row[s] == 0.0f) ++s;
        while (e > s && row[e - 1] == 0.0f) --e;
        g.mel_start[m] = s;
        g.mel_len[m] = e - s;
        g.mel_off[m] = (int)g.mel_w.size();
        g.mel_w.insert(g.mel_w.end(), row + s, row + e);
    }
    g.band_lo = 0;
    while (g.band_lo < g.n_bins && g.freqs[g.band_lo] < band_fmin)
        ++g.band_lo;
    g.band_hi = g.band_lo;
    const float fcap = std::min(band_fmax, sr / 2.0f);
    while (g.band_hi < g.n_bins && g.freqs[g.band_hi] < fcap) ++g.band_hi;
    build_fft_tables();
    return 0;
}

// waves (b, n_samples) float32 -> out (b, 56) float32
void audiofeat_extract(const float* waves, int b, float* out) {
    for_clips(b, [=](int i) {
        extract_clip(waves + (size_t)i * g.n_samples, out + (size_t)i * 56);
    });
}

}  // extern "C"
