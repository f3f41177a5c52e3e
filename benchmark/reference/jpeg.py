"""JPEG decode and resize: PIL's decoder, RGB, bilinear resize to the
model's size (what torchvision's Resize does on a PIL image); the
configuration's image wire (YUV 4:2:0, 8 bits a sample: BT.601 full-range
luma and chroma, each chroma sample the mean of a 2 x 2 block, rounded;
nearest upsampling back); then the ImageNet normalisation in float32.

The wire is a transport the configuration states (`MEC_WIRE_COMPRESS=1`
in bf16 serving) and the reference works it out itself: its chroma
subsampling alone moves a random-weight MobileNetV2's logits by ~0.58 on
average (float32 on both sides), more than the int8 arithmetic does.
The control carries it at 4 bits a sample."""

from __future__ import annotations

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def load(path: str, size: int) -> np.ndarray:
    """-> (size, size, 3) uint8."""
    from PIL import Image
    with Image.open(path) as img:
        img = img.convert('RGB').resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


KR, KB = 0.299, 0.114
KG = 1.0 - KR - KB


def wire(rgb: torch.Tensor, mode: str = 'yuv420') -> torch.Tensor:
    """(B, H, W, 3) pixels -> the same through the YUV 4:2:0 wire, 8 bits
    a sample ('yuv420') or 4 ('yuv420_4bit': luma on 16 levels, chroma on
    16 signed levels around the neutral 128); 'rgb' passes them as they
    are (float32 serving ships raw RGB)."""
    x = rgb.float()
    if mode == 'rgb':
        return x
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = KR * r + KG * g + KB * b
    u = (b - y) * (0.5 / (1.0 - KB))
    v = (r - y) * (0.5 / (1.0 - KR))
    n, h, w = y.shape
    uv = torch.stack([u, v], -1).reshape(n, h // 2, 2, w // 2, 2, 2) \
        .mean(dim=(2, 4))
    if mode == 'yuv420':
        y = torch.clamp(torch.round(y), 0, 255)
        uv = torch.clamp(torch.round(uv + 128.0), 0, 255) - 128.0
    elif mode == 'yuv420_4bit':
        y = torch.clamp(torch.round(y / 17.0), 0, 15) * 17.0
        uv = torch.clamp(torch.round(uv / 17.0), -8, 7) * 17.0
    else:
        raise ValueError(f'image wire {mode!r}')
    uv = uv.repeat_interleave(2, 1).repeat_interleave(2, 2)
    u, v = uv[..., 0], uv[..., 1]
    out = torch.stack([y + 2.0 * (1.0 - KR) * v,
                       y - 2.0 * KB * (1.0 - KB) / KG * u
                       - 2.0 * KR * (1.0 - KR) / KG * v,
                       y + 2.0 * (1.0 - KB) * u], dim=-1)
    return torch.clamp(out, 0.0, 255.0)


def normalize(u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32, ImageNet-normalised."""
    x = u8.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(STD, device=x.device)[None, :, None, None]
    return (x - mean) / std
