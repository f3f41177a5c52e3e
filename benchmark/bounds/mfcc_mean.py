"""K1 mfcc_mean (csrc/mfcc_mean.cu): the power spectrogram (B, 130, 1025)
float32 -> the time-mean of 40 MFCCs. Bytes: the spectrogram read once,
the (B, 40) result written once. Operations: the mel filters' nonzero
taps (a multiply-add each), one log per mel and frame, the DCT of the
time mean; float32 (no tensor cores)."""

import numpy as np

from benchmark.harness.peaks import bound_ms as _bound
from benchmark.reference.speech_frontend import N_BINS, N_MELS, N_MFCC, \
    tables

GLOBALS = ('mfcc_mean_kernel',)
COUNTER = ('mec_tpu_torch.ops.speech_kernels', 'mfcc_mean')
LAUNCHES = 1
FRAMES = 130


def bound_ms(batch: int) -> float:
    taps = int(np.count_nonzero(tables()['mel']))
    moved = batch * FRAMES * N_BINS * 4 + batch * N_MFCC * 4
    ops = (2 * taps * batch * FRAMES + batch * FRAMES * N_MELS
           + 2 * N_MELS * N_MFCC * batch)
    return _bound(moved, ops, 'fp32')[0]
