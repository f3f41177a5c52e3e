"""Int8-quantized convolution and dense (serving only): the port of
mec_tpu/models/qconv.py::QuantConv and ::QuantDense (the latter at the
end of this module).

Parameters come from ops/quant.quantize_conv through
convert/from_jax.image_state_from_jax: ``kernel_q`` int8 laid out
(out, kh*kw*in) with the input channel fastest (the HWIO kernel
reshaped and transposed), ``kernel_scale`` f32 per output channel,
``bias`` f32 and, in static mode, the calibrated scalar ``act_scale``.

Activations are NHWC (B, H, W, C) tensors. The op order is the JAX
module's, step for step:

  x.f32 / s_x -> round half to even -> clip +-127 -> int8
  im2col on int8 (zero padding), s8 x s8 -> s32 (torch._int_mm)
  acc.f32 * (s_x * s_c) + bias -> compute dtype

Every division is by a tensor on the activation's device: on CUDA a
division by a host scalar becomes a reciprocal multiply, which moves
the quotient by an ulp and a quantized value by one step on .5 ties.

mode='dynamic' takes s_x = max(max|x| over H, W, C, 1e-8) / 127 per
example and records ``act_amax`` = max_b(s_x) * 127 for
ops/quant.calibrate_static_scales; mode='static' takes the calibrated
scalar.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K)^T int8 -> (M, N) int32, exact.

    torch._int_mm takes more than 16 rows on CUDA (cuBLASLt), so a
    smaller operand is zero-padded and the result cut back."""
    m = a.shape[0]
    if a.is_cuda and m <= 16:
        a = torch.cat([a, a.new_zeros(17 - m, a.shape[1])])
    return torch._int_mm(a, w.t())[:m]


def im2col_nhwc(xq: torch.Tensor, kh: int, kw: int, stride: int,
                pad: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*Ho*Wo, kh*kw*C), taps in (kh, kw) order and
    channels fastest (the kernel_q layout); zero padding."""
    b, h, w, c = xq.shape
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    if kh == kw == 1 and pad == 0:
        if stride != 1:
            xq = xq[:, ::stride, ::stride, :]
        return xq.reshape(b * ho * wo, c)
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    taps = [xq[:, i:i + stride * (ho - 1) + 1:stride,
               j:j + stride * (wo - 1) + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return torch.stack(taps, dim=3).reshape(b * ho * wo, kh * kw * c)


class QuantConv(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0, mode: str = 'dynamic',
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if mode not in ('dynamic', 'static'):
            raise ValueError(f'QuantConv mode {mode!r}')
        self.cin, self.cout = cin, cout
        self.k, self.stride, self.padding = kernel_size, stride, padding
        self.mode, self.dtype = mode, dtype
        self.register_buffer('kernel_q', torch.zeros(
            cout, kernel_size * kernel_size * cin, dtype=torch.int8))
        self.register_buffer('kernel_scale', torch.ones(cout))
        self.register_buffer('bias', torch.zeros(cout))
        if mode == 'static':
            self.register_buffer('act_scale', torch.ones(()))
        self.act_amax = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        xf = x.float()
        if self.mode == 'static':
            sx = self.act_scale
        else:
            amax = xf.abs().amax(dim=(1, 2, 3), keepdim=True)
            sx = torch.clamp_min(amax, 1e-8) / torch.full(
                (), 127.0, device=x.device)
            self.act_amax = sx.max() * 127.0
        xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
        cols = im2col_nhwc(xq, self.k, self.k, self.stride, self.padding)
        acc = int8_matmul(cols, self.kernel_q)
        ho = (h + 2 * self.padding - self.k) // self.stride + 1
        wo = (w + 2 * self.padding - self.k) // self.stride + 1
        out = acc.float().reshape(b, ho, wo, self.cout) \
            * (sx * self.kernel_scale) + self.bias
        return out.to(self.dtype)


class QuantDense(nn.Module):
    """Int8 dense over the last axis of a (..., in) activation: the port
    of mec_tpu/models/qconv.py::QuantDense.

    ``kernel_q`` is int8 (out, in) (the Flax (in, out) kernel
    transposed). Dynamic scales are per ROW (every leading index keeps
    its own max-abs over the feature axis: per token for a (B, L, H)
    stream), so a padded row or a bucket-mate cannot move a request's
    logits; ``act_amax`` records max_row(s_x) * 127 for calibration.
    Static mode takes the calibrated scalar ``act_scale``. The epilogue
    is acc.f32 * (s_x * s_c) + bias, then the compute dtype."""

    def __init__(self, cin: int, cout: int, mode: str = 'dynamic',
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if mode not in ('dynamic', 'static'):
            raise ValueError(f'QuantDense mode {mode!r}')
        self.cin, self.cout, self.mode, self.dtype = cin, cout, mode, dtype
        self.register_buffer('kernel_q', torch.zeros(cout, cin,
                                                     dtype=torch.int8))
        self.register_buffer('kernel_scale', torch.ones(cout))
        self.register_buffer('bias', torch.zeros(cout))
        if mode == 'static':
            self.register_buffer('act_scale', torch.ones(()))
        self.act_amax = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xf = x.float().reshape(-1, self.cin)
        if self.mode == 'static':
            sx = self.act_scale
        else:
            amax = xf.abs().amax(dim=-1, keepdim=True)
            sx = torch.clamp_min(amax, 1e-8) / torch.full(
                (), 127.0, device=x.device)
            self.act_amax = sx.max() * 127.0
        xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
        acc = int8_matmul(xq, self.kernel_q)
        out = acc.float() * (sx * self.kernel_scale) + self.bias
        return out.to(self.dtype).reshape(*lead, self.cout)
