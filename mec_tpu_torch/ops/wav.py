"""Audio file decoding to float32 mono at a target sample rate.

A verbatim copy of mec_tpu/ops/wav.py (importing mec_tpu imports
jax); tests/test_torch_frontend.py pins it to the original.

Replaces `librosa.load` (reference preprocessing/audio_preprocessing.py:12-19)
without the librosa/soundfile/audioread dependency chain:

  * WAV (PCM 8/16/24/32-bit and IEEE float) is decoded with a self-contained
    RIFF parser (stdlib only).
  * Multi-channel audio is downmixed by averaging channels, matching
    librosa.load(mono=True).
  * Resampling to the target rate uses a polyphase FIR (scipy.resample_poly
    with a Kaiser window). librosa 0.10 defaults to soxr_hq; both are
    high-quality band-limited resamplers — bit-exactness is only guaranteed
    for files already at the target rate (the RAVDESS/TESS corpora the
    reference targets are commonly resampled anyway).
  * `duration` truncates in *native* samples before resampling, matching
    librosa.load's frame-level truncation.

mp3/ogg are accepted by the upload validator for parity with the reference
config but require an external decoder; a clear error is raised when none is
available.
"""

from __future__ import annotations

import io
import math
import os
import struct
from typing import Optional, Tuple

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class AudioDecodeError(ValueError):
    pass


def _read_chunks(data: bytes):
    """Yield (chunk_id, payload) for every top-level RIFF chunk."""
    if len(data) < 12 or data[:4] != b'RIFF' or data[8:12] != b'WAVE':
        raise AudioDecodeError('not a RIFF/WAVE file')
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos:pos + 4]
        (size,) = struct.unpack('<I', data[pos + 4:pos + 8])
        payload = data[pos + 8:pos + 8 + size]
        yield cid, payload
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode WAV bytes -> (float32 array of shape (n_channels, n_samples), sr)."""
    fmt = None
    raw = None
    for cid, payload in _read_chunks(data):
        if cid == b'fmt ':
            fmt = payload
        elif cid == b'data':
            raw = payload
            if fmt is not None:
                break
    if fmt is None or raw is None:
        raise AudioDecodeError('missing fmt/data chunk')

    (audio_format, n_channels, sample_rate, _byte_rate, _block_align,
     bits_per_sample) = struct.unpack('<HHIIHH', fmt[:16])
    if audio_format == _WAVE_FORMAT_EXTENSIBLE and len(fmt) >= 26:
        # SubFormat GUID starts with the effective format code
        (audio_format,) = struct.unpack('<H', fmt[24:26])

    if n_channels < 1:
        raise AudioDecodeError('invalid channel count')

    if audio_format == _WAVE_FORMAT_PCM:
        if bits_per_sample == 8:
            x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            x = (x - 128.0) / 128.0
        elif bits_per_sample == 16:
            x = np.frombuffer(raw, dtype='<i2').astype(np.float32) / 32768.0
        elif bits_per_sample == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            x = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = np.where(x >= (1 << 23), x - (1 << 24), x).astype(np.float32)
            x = x / float(1 << 23)
        elif bits_per_sample == 32:
            x = np.frombuffer(raw, dtype='<i4').astype(np.float32) / 2147483648.0
        else:
            raise AudioDecodeError(f'unsupported PCM width {bits_per_sample}')
    elif audio_format == _WAVE_FORMAT_IEEE_FLOAT:
        if bits_per_sample == 32:
            x = np.frombuffer(raw, dtype='<f4').astype(np.float32)
        elif bits_per_sample == 64:
            x = np.frombuffer(raw, dtype='<f8').astype(np.float32)
        else:
            raise AudioDecodeError(f'unsupported float width {bits_per_sample}')
    else:
        raise AudioDecodeError(f'unsupported WAV format code 0x{audio_format:04x}')

    x = x[: (len(x) // n_channels) * n_channels]
    return x.reshape(-1, n_channels).T, int(sample_rate)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Band-limited polyphase resampling along the last axis."""
    if orig_sr == target_sr:
        return y
    from scipy.signal import resample_poly
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out = resample_poly(y.astype(np.float64), up, down, axis=-1)
    return out.astype(np.float32)


def load_audio_file(path: str, sr: Optional[int] = 22050,
                    duration: Optional[float] = None,
                    mono: bool = True) -> Tuple[np.ndarray, int]:
    """librosa.load-compatible loader: float32, mono, resampled.

    Returns (y, sr). `duration` truncates before resampling (frame-level,
    like librosa.load's __audioread/soundfile frame limit).
    """
    ext = os.path.splitext(path)[1].lower()
    with open(path, 'rb') as f:
        data = f.read()
    if ext in ('.mp3', '.ogg'):
        raise AudioDecodeError(
            f'{ext} decoding requires an external decoder which is not '
            'available in this environment; please upload WAV')
    ch, native_sr = decode_wav_bytes(data)
    if duration is not None:
        ch = ch[:, : int(round(duration * native_sr))]
    y = ch.mean(axis=0) if (mono and ch.shape[0] > 1) else ch[0] if mono else ch
    y = np.ascontiguousarray(y, dtype=np.float32)
    if sr is not None and sr != native_sr:
        y = resample(y, native_sr, sr)
        return y, sr
    return y, native_sr


def write_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write a float32 mono signal as 16-bit PCM WAV (test/tooling helper)."""
    y = np.asarray(y, dtype=np.float32)
    pcm = np.clip(y * 32767.0, -32768, 32767).astype('<i2')
    data = pcm.tobytes()
    with open(path, 'wb') as f:
        f.write(b'RIFF')
        f.write(struct.pack('<I', 36 + len(data)))
        f.write(b'WAVE')
        f.write(b'fmt ')
        f.write(struct.pack('<IHHIIHH', 16, _WAVE_FORMAT_PCM, 1, sr,
                            sr * 2, 2, 16))
        f.write(b'data')
        f.write(struct.pack('<I', len(data)))
        f.write(data)


def load_and_fix_length(path: str, sr: int = 22050, duration: int = 3
                        ) -> Tuple[np.ndarray, int]:
    """Load + zero-pad/trim to exactly sr*duration samples.

    Mirrors reference preprocessing/audio_preprocessing.py:12-19 (load_audio).
    """
    y, sr = load_audio_file(path, sr=sr, duration=duration)
    target = sr * duration
    if len(y) < target:
        y = np.pad(y, (0, target - len(y)), mode='constant')
    else:
        y = y[:target]
    return y, sr
