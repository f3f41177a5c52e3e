"""Wire codecs for the host->device link: packed 12-bit PCM and YUV 4:2:0.

Port of mec_tpu/serving/wire.py. Audio: each clip ships as
12-bit linear PCM codes with a per-clip scale, two samples packed into
three bytes (37.5% of the float32 bytes); the engine encodes on the
host and expands on the device. 8-bit codecs are not usable: their
noise floor sits above power_to_db's top_db=-80 dB clamp and moves
log-scale MFCCs (see the original's module docstring).

Images ship as YUV 4:2:0 (BT.601 full range, chroma averaged over 2x2
blocks): 1.5 bytes per pixel instead of 3 for uint8 RGB.

`encode_pcm12` and `encode_yuv420` dispatch as the original's do: to
the single-pass C++ loops of native/wirecodec.cpp (a copy of
mec_tpu/native/wirecodec.cpp) when g++ built them, else to
`encode_pcm12_np` and `encode_yuv420_np`, the original's numpy
encoders, copied, which are the meaning (pcm12: the same bytes; YUV:
within one code, the original's contract). `decode_pcm12` and
`decode_yuv420` are the same arithmetic in torch tensor ops and run on
whatever device the wire bytes live on.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from mec_tpu_torch.native.build import load_library

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)

_Q12 = 2047.0   # 12-bit symmetric quantizer: codes in [-2047, 2047]
_KR, _KG, _KB = 0.299, 0.587, 0.114   # BT.601 luma weights


@functools.lru_cache(maxsize=1)
def _native() -> Optional[ctypes.CDLL]:
    lib = load_library('wirecodec')
    if lib is None:
        return None
    lib.pcm12_encode.restype = None
    lib.pcm12_encode.argtypes = [_F32P, ctypes.c_int32, ctypes.c_int64,
                                 _U8P, _F32P]
    lib.yuv420_encode.restype = None
    lib.yuv420_encode.argtypes = [_U8P, ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32, _U8P, _U8P]
    return lib


def encode_pcm12(waves: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, N) float32 -> (packed (B, 3N/2) uint8, scale (B, 1) float32),
    natively when g++ built wirecodec, else encode_pcm12_np."""
    b, n = waves.shape
    if n % 2:
        raise ValueError(f'encode_pcm12: {n} samples a clip, not even')
    lib = _native()
    if lib is None:
        return encode_pcm12_np(waves)
    waves = np.ascontiguousarray(waves, np.float32)
    packed = np.empty((b, 3 * n // 2), np.uint8)
    scale = np.empty((b, 1), np.float32)
    lib.pcm12_encode(waves.ctypes.data_as(_F32P), b, n,
                     packed.ctypes.data_as(_U8P), scale.ctypes.data_as(_F32P))
    return packed, scale


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
    """Inverse of encode_pcm12 -> (B, N) float32, on packed's device.

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


def encode_yuv420(imgs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) uint8 RGB -> (Y (B, H, W), UV (B, H/2, W/2, 2)) uint8,
    natively when g++ built wirecodec, else encode_yuv420_np."""
    b, h, w, _ = imgs.shape
    if h % 2 or w % 2:
        raise ValueError(f'encode_yuv420: {h}x{w} images, not even')
    lib = _native()
    if lib is None:
        return encode_yuv420_np(imgs)
    imgs = np.ascontiguousarray(imgs, np.uint8)
    y8 = np.empty((b, h, w), np.uint8)
    uv8 = np.empty((b, h // 2, w // 2, 2), np.uint8)
    lib.yuv420_encode(imgs.ctypes.data_as(_U8P), b, h, w,
                      y8.ctypes.data_as(_U8P), uv8.ctypes.data_as(_U8P))
    return y8, uv8


def encode_yuv420_np(imgs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W, 3) uint8 RGB -> (Y (B, H, W), UV (B, H/2, W/2, 2)) uint8.

    H and W must be even."""
    b, h, w, _ = imgs.shape
    rgb = imgs.astype(np.float32)
    r, g, bl = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = _KR * r + _KG * g + _KB * bl
    u = (bl - y) * (0.5 / (1.0 - _KB)) + 128.0
    v = (r - y) * (0.5 / (1.0 - _KR)) + 128.0
    uv = np.stack([u, v], axis=-1)
    uv = uv.reshape(b, h // 2, 2, w // 2, 2, 2).mean(axis=(2, 4))
    return (np.clip(np.rint(y), 0, 255).astype(np.uint8),
            np.clip(np.rint(uv), 0, 255).astype(np.uint8))


def decode_yuv420(y8: torch.Tensor, uv8: torch.Tensor) -> torch.Tensor:
    """(Y, UV) uint8 -> (B, H, W, 3) float32 RGB in [0, 255], on y8's
    device. Nearest-neighbour chroma upsampling (an expand + reshape)."""
    y = y8.to(torch.float32)
    uv = uv8.to(torch.float32) - 128.0
    b, hh, hw, _ = uv.shape
    uv = uv[:, :, None, :, None, :].expand(b, hh, 2, hw, 2, 2) \
        .reshape(b, 2 * hh, 2 * hw, 2)
    u, v = uv[..., 0], uv[..., 1]
    r = y + (2.0 * (1.0 - _KR)) * v
    g = y - (2.0 * _KB * (1.0 - _KB) / _KG) * u \
        - (2.0 * _KR * (1.0 - _KR) / _KG) * v
    bl = y + (2.0 * (1.0 - _KB)) * u
    return torch.clamp(torch.stack([r, g, bl], dim=-1), 0.0, 255.0)
