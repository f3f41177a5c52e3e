"""ctypes binding of the native 56-dim audio featurizer (audiofeat.cpp).

A copy of mec_tpu/native/featurizer.py. With the host audio features on
(Config.HOST_AUDIO_FEATURES in bf16, serving/engine.py), the engine
featurizes each clip on the host and ships its 56 float32 features
(224 bytes) instead of the packed waveform. The constant operators come
from the port's ops/filters.py, the same tables the device frontend
uses, and are installed into the library once a process
(audiofeat_init copies them). Clips of another length than
Config.AUDIO_SAMPLES, and hosts without g++, take the numpy version
(ops/host_features.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from mec_tpu_torch.config import Config
from mec_tpu_torch.native.build import load_library
from mec_tpu_torch.ops import filters

_F32P = ctypes.POINTER(ctypes.c_float)


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    lib = load_library('audiofeat')
    if lib is None:
        return None
    lib.audiofeat_init.restype = ctypes.c_int
    lib.audiofeat_init.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        _F32P, _F32P, _F32P, _F32P, _F32P,
        ctypes.c_float, ctypes.c_float]
    lib.audiofeat_extract.restype = None
    lib.audiofeat_extract.argtypes = [_F32P, ctypes.c_int, _F32P]
    hann = np.ascontiguousarray(filters.hann_window(Config.N_FFT))
    mel = np.ascontiguousarray(filters.mel_filterbank(
        Config.SAMPLE_RATE, Config.N_FFT, Config.N_MELS))
    dct = np.ascontiguousarray(filters.dct_matrix(Config.N_MFCC,
                                                  Config.N_MELS))
    freqs = np.ascontiguousarray(filters.fft_frequencies(
        Config.SAMPLE_RATE, Config.N_FFT).astype(np.float32))
    base = np.ascontiguousarray(filters.chroma_base_bins(
        Config.SAMPLE_RATE, Config.N_FFT).astype(np.float32))
    rc = lib.audiofeat_init(
        Config.N_FFT, Config.HOP_LENGTH, Config.AUDIO_SAMPLES,
        Config.N_MELS, Config.N_MFCC,
        ctypes.c_float(float(Config.SAMPLE_RATE)),
        hann.ctypes.data_as(_F32P), mel.ctypes.data_as(_F32P),
        dct.ctypes.data_as(_F32P), freqs.ctypes.data_as(_F32P),
        base.ctypes.data_as(_F32P),
        ctypes.c_float(150.0), ctypes.c_float(4000.0))
    if rc != 0:
        raise RuntimeError(f'audiofeat_init returned {rc} (N_FFT '
                           f'{Config.N_FFT} must be a power of two)')
    return lib


def have_native() -> bool:
    """Whether extract56 runs the C++ featurizer (g++ found)."""
    return _lib() is not None


def extract56(waves: np.ndarray) -> np.ndarray:
    """(N,) or (B, N) float32 waveforms -> (B, 56) float32 features.

    The C++ single pass (threaded across clips) for clips of
    Config.AUDIO_SAMPLES samples when g++ built it; otherwise
    ops.host_features.features_56_np (the C loop's tables are sized
    for that length, so any other length takes numpy)."""
    waves = np.asarray(waves, np.float32)
    if waves.ndim == 1:
        waves = waves[None, :]
    lib = _lib()
    if lib is None or waves.shape[1] != Config.AUDIO_SAMPLES:
        from mec_tpu_torch.ops import host_features
        return host_features.features_56_np(waves)
    waves = np.ascontiguousarray(waves)
    out = np.empty((waves.shape[0], 56), np.float32)
    lib.audiofeat_extract(waves.ctypes.data_as(_F32P), waves.shape[0],
                          out.ctypes.data_as(_F32P))
    return out
