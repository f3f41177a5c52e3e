"""Where the reference computes in float32, and where its control computes
one step lower.

Every product the reference computes names the stage it belongs to
(a key of the configuration's "precision" table, whose entries are
[stated, control]). The exact reference (`Prec(table, control=False)`) computes every
stage in float32 with TF32 off, and carries the image wire the table
states. The control (`Prec(table)`) rounds the operands of each stage to
the control precision of its entry:

  int4  for a stage the program computes in int8 (weights per output
        channel, activations per tensor with static scales calibrated at
        load): the weights per output channel, symmetric, and the
        activations with static scales worked out as the program works
        out its own (1.25 x the largest magnitude each product's input
        reaches over the program's calibration inputs), at 4 bits;
  fp8   both operands to float8 e4m3 with a per-tensor scale, for bf16;
  tf32  both operands to a 10-bit mantissa, for float32 products;
  bf16  the values to bfloat16, for float32 elementwise stages;
  pcm8  the waveform to 8 bits a sample with a per-clip scale, for the
        12-bit waveform wire;
  yuv420_4bit  the photo through the YUV 4:2:0 wire at 4 bits a sample,
        for the 8-bit one (benchmark/reference/jpeg.py::wire);
  fp32  unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest-even at a 10-bit mantissa."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def quant_sym(x: torch.Tensor, bits: int, dim: Optional[int]) -> torch.Tensor:
    """Symmetric fake quantization to `bits`, per slice along `dim` (None:
    per tensor)."""
    q = 2 ** (bits - 1) - 1
    if dim is None:
        amax = x.abs().amax()
    else:
        red = [d for d in range(x.dim()) if d != dim % x.dim()]
        amax = x.abs().amax(dim=red, keepdim=True)
    s = amax.clamp_min(1e-30) / q
    return torch.clamp(torch.round(x / s), -q, q) * s


class Prec:
    def __init__(self, table: Optional[Dict[str, List[str]]] = None,
                 control: bool = True):
        """table: the configuration's precision table; control=False is
        the exact reference, which computes every stage in float32 and
        carries the image wire as the table states it."""
        table = table or {}
        self.modes = {k: v[1] for k, v in table.items()} if control else {}
        self.image_wire = table.get('image_wire', ['rgb', 'rgb'])[
            1 if control else 0]
        # int4 stages' static activation ranges, by stage, one a product
        # in the order a forward computes them
        self.amax: Dict[str, List[torch.Tensor]] = {}
        self.calibrating = False
        self._calls: Dict[str, int] = {}

    def mode(self, stage: str) -> str:
        return self.modes.get(stage, 'fp32')

    def needs_calibration(self) -> bool:
        return 'int4' in self.modes.values()

    def start(self) -> None:
        """Before each forward of a block: its products count from 0."""
        self._calls = {}

    def _static(self, x: torch.Tensor, stage: str) -> torch.Tensor:
        i = self._calls.get(stage, 0)
        self._calls[stage] = i + 1
        if self.calibrating:
            self.amax.setdefault(stage, []).append(x.abs().amax())
            return x
        s = (1.25 * self.amax[stage][i]).clamp_min(1e-8) / 7.0
        return torch.clamp(torch.round(x / s), -7, 7) * s

    def values(self, x: torch.Tensor, stage: str) -> torch.Tensor:
        """An elementwise stage's values."""
        m = self.mode(stage)
        if m == 'bf16':
            return x.to(torch.bfloat16).float()
        if m == 'tf32':
            return round_tf32(x)
        return x

    def operands(self, x: torch.Tensor, w: torch.Tensor, stage: str,
                 w_out_dim: int):
        """(x, w) of a product of `stage`; w's output channels lie along
        w_out_dim."""
        m = self.mode(stage)
        if m == 'int4':
            return self._static(x, stage), quant_sym(w, 4, w_out_dim)
        if m == 'fp8':
            return round_fp8(x), round_fp8(w)
        if m == 'tf32':
            return round_tf32(x), round_tf32(w)
        if m == 'bf16':
            return (x.to(torch.bfloat16).float(),
                    w.to(torch.bfloat16).float())
        return x, w

    def linear(self, x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor], stage: str) -> torch.Tensor:
        """x @ kernel + bias, kernel in the Flax (in, out) layout."""
        x, kernel = self.operands(x, kernel, stage, -1)
        y = x @ kernel
        return y if bias is None else y + bias

    def matmul(self, a: torch.Tensor, b: torch.Tensor, stage: str
               ) -> torch.Tensor:
        """a @ b of two activations (attention scores and context)."""
        m = self.mode(stage)
        if m in ('fp8', 'tf32', 'bf16'):
            a, b = self.operands(a, b, stage, -1)
        return a @ b

    def conv(self, x: torch.Tensor, kernel_hwio: torch.Tensor,
             stride: int, padding: int, groups: int, stage: str
             ) -> torch.Tensor:
        """NCHW conv with a Flax HWIO kernel."""
        w = kernel_hwio.permute(3, 2, 0, 1)
        x, w = self.operands(x, w, stage, 0)
        return F.conv2d(x, w, None, stride, padding, 1, groups)

    def wave(self, y: torch.Tensor, stage: str) -> torch.Tensor:
        """The waveform as the wire of `stage` would carry it."""
        if self.mode(stage) != 'pcm8':
            return y
        return quant_sym(y, 8, 0)
