"""WAV decode, pad or crop: 16-bit PCM through the standard library's
`wave` reader, samples / 32768, channels averaged, then zero-padded or
cut to seconds * rate samples (librosa.load at the file's own rate, then
the reference's fix-length)."""

from __future__ import annotations

import wave

import numpy as np


def load(path: str, rate: int = 22050, seconds: int = 3) -> np.ndarray:
    with wave.open(path, 'rb') as w:
        if w.getsampwidth() != 2 or w.getframerate() != rate:
            raise ValueError(f'{path}: expected 16-bit PCM at {rate} Hz')
        pcm = np.frombuffer(w.readframes(w.getnframes()), '<i2')
        ch = w.getnchannels()
    y = pcm.reshape(-1, ch).astype(np.float32).mean(axis=1) / 32768.0
    n = rate * seconds
    out = np.zeros(n, np.float32)
    out[:min(n, len(y))] = y[:n]
    return out
