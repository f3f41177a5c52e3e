"""The one traffic generator: every mix is a data file of parameters
(benchmark/traffic/<name>.json) that this module reads.

Sizes are fixed by the mix's `shape_seed` and only their order by the
run's seed: each run sends the same multiset of sentence lengths and
clip lengths, shuffled, with new words, new clip and photo contents and
new picks of clip and photo, at the same arrival times (open loop). So
seeds change the inputs but not the amount of work or its timing.

Inputs of one request: a sentence (lognormal word count with a long
tail; Zipf words over the vocabulary's whole words, a share of them out
of vocabulary), a WAV clip from a pool (16-bit mono; a voiced signal:
harmonics with vibrato under formants, shaped noise, syllable envelope
and a pause) and a JPEG photo from a pool (smooth gradient, blotches,
shapes and noise). The pools are drawn on the run's device in a few
large calls, then written under a work directory.
"""

from __future__ import annotations

import concurrent.futures
import io
import math
import os
import wave
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


def _stream(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit torch generator seed derived from (seed, stream)."""
    return int(np.random.SeedSequence([int(seed), stream])
               .generate_state(2, np.uint32).astype(np.uint64)
               .view(np.uint64)[0] >> np.uint64(1))


def word_counts(text: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n sentence lengths in words: lognormal around the median, and a
    `tail_share` drawn uniformly over `tail_words`; none longer than the
    tail's end."""
    lo, hi = text['tail_words']
    body = np.exp(rng.normal(math.log(text['median_words']), text['sigma'],
                             n))
    tail = rng.uniform(lo, hi, n)
    use_tail = rng.random(n) < text['tail_share']
    return np.clip(np.rint(np.where(use_tail, tail, body)), 1, hi).astype(int)


def zipf_ranks(n: int, vocab_words: int, s: float,
               rng: np.random.Generator) -> np.ndarray:
    """n word ranks in [0, vocab_words): P(r) proportional to 1/(r+1)^s."""
    w = 1.0 / np.arange(1, vocab_words + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(n)), vocab_words - 1)


def arrival_times(rate: float, seconds: float, shape_seed: int
                  ) -> np.ndarray:
    """Due times in [0, seconds) of round(rate * seconds) Poisson arrivals:
    the gaps drawn from shape_seed and normalised to fill the window. The
    same for every run seed: the seed changes what arrives, not when."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(shape_seed).exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


@dataclass
class Request:
    index: int
    text: str
    audio_path: str
    image_path: str
    due: Optional[float] = None       # open loop: seconds after the start
    n_words: int = 0

    def payload(self) -> Dict[str, str]:
        return {'audio_path': self.audio_path, 'text': self.text,
                'image_path': self.image_path}


@dataclass
class Traffic:
    """All requests of one run: `warmup` (sent before the window and not
    timed) and `timed` (the window's, in order; a closed loop that runs
    past the end starts again from the first)."""
    warmup: List[Request] = field(default_factory=list)
    timed: List[Request] = field(default_factory=list)
    clip_seconds: List[float] = field(default_factory=list)


def _sentence(ranks: np.ndarray, oov: np.ndarray, partner: np.ndarray,
              words: List[str]) -> str:
    out = []
    for j, (r, o, p) in enumerate(zip(ranks, oov, partner)):
        w = words[r] + words[p] if o else words[r]
        if j % 9 == 8:
            w += ','
        out.append(w)
    return ' '.join(out) + '.'


def make_texts(text: Dict, counts: np.ndarray, words: List[str],
               rng: np.random.Generator) -> List[str]:
    total = int(counts.sum())
    ranks = zipf_ranks(total, len(words), text['zipf_s'], rng)
    partner = zipf_ranks(total, len(words), text['zipf_s'], rng)
    oov = rng.random(total) < text['oov_share']
    ends = np.cumsum(counts)
    starts = ends - counts
    return [_sentence(ranks[a:b], oov[a:b], partner[a:b], words)
            for a, b in zip(starts, ends)]


# ---------------------------------------------------------------- audio
def synth_clips(lengths: np.ndarray, sr: int, rng: np.random.Generator,
                device: torch.device, gen: torch.Generator) -> List[np.ndarray]:
    """Voiced clips, float32 in [-1, 1], one per length (samples): a
    glottal-like harmonic series (f0 90-260 Hz with vibrato and a slow
    glide) under three formants, formant-shaped noise, a syllable-rate
    envelope and one pause; peak level 0.1-0.9."""
    n = len(lengths)
    L = int(lengths.max())
    t = torch.arange(L, device=device, dtype=torch.float32) / sr
    p = {k: torch.as_tensor(v, dtype=torch.float32, device=device)[:, None]
         for k, v in dict(
             f0=rng.uniform(90, 260, n), glide=rng.uniform(-0.15, 0.15, n),
             vib_rate=rng.uniform(4, 7, n), vib=rng.uniform(0.005, 0.03, n),
             f1=rng.uniform(300, 900, n), f2=rng.uniform(900, 2500, n),
             f3=rng.uniform(2200, 3300, n), noise=rng.uniform(0.02, 0.3, n),
             syl=rng.uniform(3, 6, n), peak=rng.uniform(0.1, 0.9, n),
             pause_at=rng.uniform(0.2, 0.8, n),
             pause_len=rng.uniform(0.1, 0.5, n)).items()}
    dur = torch.as_tensor(lengths / sr, dtype=torch.float32,
                          device=device)[:, None]
    f0 = p['f0'] * (1 + p['glide'] * t / dur) * (
        1 + p['vib'] * torch.sin(2 * math.pi * p['vib_rate'] * t))
    phase = 2 * math.pi * torch.cumsum(f0, dim=1) / sr
    y = torch.zeros(n, L, device=device)

    def formants(f):
        return sum(torch.exp(-0.5 * ((f - p[k]) / bw) ** 2)
                   for k, bw in (('f1', 120.0), ('f2', 200.0), ('f3', 300.0)))

    for h in range(1, 16):
        fh = h * p['f0']
        y += formants(fh) / h * torch.sin(h * phase)
    # formant-shaped noise, by filtering white noise in frequency
    white = torch.randn(n, L, device=device, generator=gen)
    spec = torch.fft.rfft(white, dim=1)
    freqs = torch.fft.rfftfreq(L, 1.0 / sr).to(device)[None, :]
    noise = torch.fft.irfft(spec * (0.2 + formants(freqs)), n=L, dim=1)
    noise = noise / noise.std(dim=1, keepdim=True).clamp_min(1e-6)
    y = y / y.std(dim=1, keepdim=True).clamp_min(1e-6) + p['noise'] * noise
    env = 0.55 + 0.45 * torch.sin(2 * math.pi * p['syl'] * t) ** 2
    pause = ((t / dur >= p['pause_at'])
             & (t / dur < p['pause_at'] + p['pause_len'] / dur))
    live = t[None, :] < dur
    y = y * env * (~pause) * live
    y = y / y.abs().amax(dim=1, keepdim=True).clamp_min(1e-6) * p['peak']
    y = y.cpu().numpy()
    return [y[i, :int(lengths[i])] for i in range(n)]


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    pcm = np.clip(np.rint(y * 32767.0), -32768, 32767).astype('<i2')
    with wave.open(path, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


# ---------------------------------------------------------------- images
def synth_images(n: int, h: int, w: int, rng: np.random.Generator,
                 device: torch.device, gen: torch.Generator) -> np.ndarray:
    """(n, h, w, 3) uint8 photos: a two-colour gradient at a random angle,
    smooth blotches (coarse noise upsampled), 3-6 soft ellipses and
    rectangles, and pixel noise."""
    yy = torch.linspace(-1, 1, h, device=device)[:, None]
    xx = torch.linspace(-1, 1, w, device=device)[None, :] * (w / h)
    ang = torch.as_tensor(rng.uniform(0, 2 * math.pi, n), device=device,
                          dtype=torch.float32)[:, None, None]
    ramp = (torch.cos(ang) * xx + torch.sin(ang) * yy + 1.5) / 3.0
    c0 = torch.as_tensor(rng.uniform(0, 255, (n, 3)), device=device,
                         dtype=torch.float32)[:, :, None, None]
    c1 = torch.as_tensor(rng.uniform(0, 255, (n, 3)), device=device,
                         dtype=torch.float32)[:, :, None, None]
    img = c0 + (c1 - c0) * ramp[:, None]
    coarse = torch.randn(n, 3, 6, 8, device=device, generator=gen)
    img = img + 40.0 * torch.nn.functional.interpolate(
        coarse, size=(h, w), mode='bicubic', align_corners=False)
    k = 6
    cx, cy = rng.uniform(-1.2, 1.2, (n, k)), rng.uniform(-0.9, 0.9, (n, k))
    rx, ry = rng.uniform(0.08, 0.5, (n, k)), rng.uniform(0.08, 0.5, (n, k))
    col = rng.uniform(0, 255, (n, k, 3))
    rect = rng.random((n, k)) < 0.4
    on = rng.integers(3, k + 1, n)[:, None] > np.arange(k)[None, :]
    for j in range(k):
        def T(a):
            return torch.as_tensor(a[:, j], device=device,
                                   dtype=torch.float32)[:, None, None]
        dx, dy = (xx - T(cx)) / T(rx), (yy - T(cy)) / T(ry)
        ell = dx ** 2 + dy ** 2
        box = torch.maximum(dx.abs(), dy.abs()) ** 2
        d = torch.where(T(rect.astype(np.float32)) > 0, box, ell)
        alpha = torch.sigmoid((1.0 - d) * 12.0) * T(on.astype(np.float32))
        c = torch.as_tensor(col[:, j], device=device,
                            dtype=torch.float32)[:, :, None, None]
        img = img * (1 - alpha[:, None]) + c * alpha[:, None]
    img = img + 6.0 * torch.randn(img.shape, device=device, generator=gen)
    img = img.clamp(0, 255).round().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def _jpeg(path: str, arr: np.ndarray, quality: int) -> None:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr, 'RGB').save(buf, 'JPEG', quality=quality)
    with open(path, 'wb') as f:
        f.write(buf.getvalue())


# ---------------------------------------------------------------- the run
def build(mix: Dict, seed: int, seconds: float, words: List[str],
          workdir: str, device: torch.device) -> Traffic:
    """Draw the pools, write them under workdir, and list the requests."""
    shape = np.random.default_rng(mix['shape_seed'])
    rng = _stream(seed, 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 2))
    a, im = mix['audio'], mix['image']
    sr = a['sample_rate']
    lengths = rng.permutation(np.rint(
        shape.uniform(*a['seconds'], a['pool']) * sr).astype(int))
    clips = synth_clips(lengths, sr, rng, device, gen)
    photos = np.concatenate([
        synth_images(min(64, im['pool'] - k), im['height'], im['width'],
                     rng, device, gen) for k in range(0, im['pool'], 64)])
    wavs = [os.path.join(workdir, f'clip_{i:04d}.wav')
            for i in range(a['pool'])]
    jpgs = [os.path.join(workdir, f'photo_{i:04d}.jpg')
            for i in range(im['pool'])]
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        list(ex.map(lambda i: write_wav(wavs[i], clips[i], sr),
                    range(len(wavs))))
        list(ex.map(lambda i: _jpeg(jpgs[i], photos[i], im['quality']),
                    range(len(jpgs))))

    if mix['loop'] == 'open':
        due = arrival_times(mix['rate_per_s'], seconds, mix['shape_seed'])
        n_timed = len(due)
    else:
        due = None
        n_timed = int(math.ceil(mix['max_requests_per_s'] * seconds))
    n_warm = mix['warmup_requests']
    n = n_warm + n_timed
    counts = np.concatenate([
        word_counts(mix['text'], n_warm, shape),
        rng.permutation(word_counts(mix['text'], n_timed, shape))])
    texts = make_texts(mix['text'], counts, words, rng)
    clip_i = rng.integers(0, a['pool'], n)
    photo_i = rng.integers(0, im['pool'], n)
    reqs = [Request(i, texts[i], wavs[clip_i[i]], jpgs[photo_i[i]],
                    n_words=int(counts[i])) for i in range(n)]
    if due is not None:
        for r, d in zip(reqs[n_warm:], due):
            r.due = float(d)
    return Traffic(reqs[:n_warm], reqs[n_warm:],
                   [float(x) / sr for x in lengths])
