"""Audio preprocessing: the port of mec_tpu/preprocessing/
audio_preprocessing.py, the reference's public API
(reference preprocessing/audio_preprocessing.py) over the port's fp32
parity frontend (ops/audio_features.py: the rFFT STFT, the MFCC by two
matmuls, the tuning selection K2, the cumsum rolloff).

Functions take a 1-D waveform (as librosa loads it) or a WAV path and
return one clip's features as float32 numpy. Each takes `device`
('cuda', the default, or 'cpu'); 'cuda' needs a card and never falls
back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import wav as _wav


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    return dev


def _fix_length(audio: np.ndarray, sr: int, duration: int) -> np.ndarray:
    target = sr * duration
    audio = np.asarray(audio, dtype=np.float32)
    if len(audio) < target:
        return np.pad(audio, (0, target - len(audio)), mode='constant')
    return audio[:target]


def load_audio(file_path: str, sr: int = Config.SAMPLE_RATE,
               duration: int = Config.AUDIO_DURATION):
    """Load and pad or trim to exactly sr * duration samples -> (audio,
    sr) (reference audio_preprocessing.py:12-19)."""
    return _wav.load_and_fix_length(file_path, sr=sr, duration=duration)


def _as_batch(audio, device) -> torch.Tensor:
    audio = _fix_length(audio, Config.SAMPLE_RATE, Config.AUDIO_DURATION)
    return torch.from_numpy(audio[None, :]).to(_device(device))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().astype(np.float32)


def extract_mfcc(audio, sr=Config.SAMPLE_RATE, n_mfcc=Config.N_MFCC, *,
                 device='cuda') -> np.ndarray:
    """40 time-averaged MFCCs (reference audio_preprocessing.py:22-24)."""
    P = af.stft_spectrograms(_as_batch(audio, device))[1]
    return _host(af.mfcc_mean_from_power(P))[0][:n_mfcc]


def extract_chroma(audio, sr=Config.SAMPLE_RATE, *,
                   device='cuda') -> np.ndarray:
    """12 time-averaged chroma bins (reference
    audio_preprocessing.py:27-29)."""
    P = af.stft_spectrograms(_as_batch(audio, device))[1]
    return _host(af.chroma_mean_from_power(P))[0]


def extract_spectral_features(audio, sr=Config.SAMPLE_RATE, *,
                              device='cuda') -> np.ndarray:
    """[zcr, centroid, rolloff, rms] (reference
    audio_preprocessing.py:32-37)."""
    return _host(af.spectral_features_4(_as_batch(audio, device)))[0]


def preprocess_audio(file_path: str, *, device='cuda') -> np.ndarray:
    """WAV path -> float32[56] (reference audio_preprocessing.py:40-46)."""
    audio, _sr = load_audio(file_path)
    y = torch.from_numpy(audio[None, :]).to(_device(device))
    return _host(af.audio_features_56(y, 'parity'))[0]


def preprocess_audio_batch(file_paths, *, device='cuda') -> np.ndarray:
    """The batched form (no reference counterpart): N paths -> (N, 56)."""
    waves = np.stack([load_audio(p)[0] for p in file_paths])
    y = torch.from_numpy(waves).to(_device(device))
    return _host(af.audio_features_56(y, 'parity'))
