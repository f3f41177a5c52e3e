"""Audio wire codec for the host->device link: packed 12-bit PCM.

Port of the audio half of mec_tpu/serving/wire.py. Each clip ships as
12-bit linear PCM codes with a per-clip scale, two samples packed into
three bytes (37.5% of the float32 bytes); the engine encodes on the
host and expands on the device. 8-bit codecs are not usable: their
noise floor sits above power_to_db's top_db=-80 dB clamp and moves
log-scale MFCCs (see the original's module docstring).

`encode_pcm12_np` is the original's numpy encoder, copied; `decode_pcm12`
is the same integer unpacking in torch tensor ops and runs on whatever
device the packed bytes live on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_Q12 = 2047.0   # 12-bit symmetric quantizer: codes in [-2047, 2047]


def encode_pcm12_np(waves: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, N) float32 -> (packed (B, 3N/2) uint8, scale (B, 1) float32).

    N must be even. Codes are offset-binary 12-bit; sample pairs
    (u0, u1) pack as [u0 >> 4, (u0 & 15) << 4 | u1 >> 8, u1 & 255].
    """
    b, n = waves.shape
    scale = np.maximum(np.abs(waves).max(axis=1, keepdims=True),
                       1e-6).astype(np.float32)
    q = np.rint(waves / scale * _Q12).astype(np.int32)      # [-2047, 2047]
    u = (np.clip(q, -_Q12, _Q12) + 2048).astype(np.uint16)  # 12-bit codes
    u = u.reshape(b, n // 2, 2)
    u0, u1 = u[..., 0].astype(np.uint32), u[..., 1].astype(np.uint32)
    packed = np.stack([u0 >> 4,
                       ((u0 & 15) << 4) | (u1 >> 8),
                       u1 & 255], axis=-1).astype(np.uint8)
    return packed.reshape(b, 3 * n // 2), scale


def decode_pcm12(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_pcm12_np -> (B, N) float32, on packed's device.

    Integer shifts and an interleave; the final multiply by
    scale / 2047 rounds exactly as the JAX decoder does (one f32
    divide, one f32 multiply)."""
    b, m = packed.shape
    p = packed.reshape(b, m // 3, 3).to(torch.int32)
    b0, b1, b2 = p[..., 0], p[..., 1], p[..., 2]
    u0 = (b0 << 4) | (b1 >> 4)
    u1 = ((b1 & 15) << 8) | b2
    u = torch.stack([u0, u1], dim=-1).reshape(b, 2 * (m // 3))
    return (u - 2048).to(torch.float32) * (scale / _Q12)
