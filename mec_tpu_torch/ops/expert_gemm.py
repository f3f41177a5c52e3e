"""The grouped expert GEMM of a dropless top-k mixture-of-experts layer with
shared experts (Moonlight-16B-A3B's deepseek_v3 layer).

route() sorts a layer's token-expert pairs by expert on the device (a
stable argsort): each real token's k routed pairs and one pair with each
shared expert (weight 1), padding tokens none. Its row offsets are the
cumulative sum of a bincount (scatter_add), so nothing is read back to
the host and the step stays capturable in a CUDA graph.
grouped_expert_gemm() then computes every pair's weighted SwiGLU expert
output, (P, H) float32 in sorted order: for a CUDA tensor in two
launches of
csrc/grouped_expert_gemm.cu (gate and up with SwiGLU in the epilogue;
down with the routing weight in the epilogue), counted once a call in
`grouped_expert_gemm.launches`; for a CPU tensor in the plain version,
a loop over the experts. combine() sums each token's pairs in float32
in a fixed order (no atomics: a replay repeats eager bit for bit).

Weights are in nn.Linear's (out, in) layout: routed experts stacked per
layer, gate and up (E, I, H) and down (E, H, I); the shared experts as
published, gate and up (S*I, H) and down (H, S*I), shared expert s being
rows (columns of down) s*I .. (s+1)*I.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mec_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
# largest expert count the kernel takes (csrc/grouped_expert_gemm.cu)
MAX_EXPERTS = 255


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library()
    lib.mec_expert_gate_up.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _P, _P]
    lib.mec_expert_gate_up.restype = _I
    lib.mec_expert_down.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _P, _P]
    lib.mec_expert_down.restype = _I
    return lib


class Routing(NamedTuple):
    offsets: torch.Tensor   # (E + S + 1,) int32: sorted rows of each expert
    src: torch.Tensor       # (P,) int32: the token of each sorted pair
    weight: torch.Tensor    # (P,) float32: its routing weight
    pos: torch.Tensor       # (T, k + S) int64: each token's pairs' positions
    counts: torch.Tensor    # (E + S + 1,) int32: pairs an expert (+ padding)


def route(topk_idx: torch.Tensor, topk_w: torch.Tensor, valid: torch.Tensor,
          n_routed: int, n_shared: int) -> Routing:
    """topk_idx (T, k) routed experts of each token, topk_w (T, k) their
    float32 weights, valid (T,) bool (False: a padding token). Every real
    token gets its k routed pairs and n_shared shared pairs; a padding
    token's pairs go to a sentinel past the last expert and are sorted
    last, outside every expert's rows. Within an expert, pairs keep the
    order (token, slot)."""
    T, k = topk_idx.shape
    dev = topk_idx.device
    n_exp = n_routed + n_shared
    shared = torch.arange(n_routed, n_exp, device=dev).expand(T, n_shared)
    expert = torch.cat([topk_idx.long(), shared], 1)
    expert = torch.where(valid[:, None], expert, n_exp)
    weight = torch.cat([topk_w.float(),
                        torch.ones(T, n_shared, device=dev)], 1)
    flat = expert.reshape(-1)
    order = torch.argsort(flat, stable=True)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(flat.numel(), device=dev))
    counts = torch.zeros(n_exp + 1, dtype=torch.int32, device=dev) \
        .scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros(1),
                         counts[:n_exp].cumsum(0, dtype=torch.int32)])
    src = (order // (k + n_shared)).to(torch.int32)
    return Routing(offsets, src, weight.reshape(-1)[order],
                   pos.view(T, k + n_shared), counts)


def combine(y: torch.Tensor, routing: Routing, valid: torch.Tensor
            ) -> torch.Tensor:
    """(T, H) float32: each real token's pairs of y (P, H) summed in slot
    order; padding tokens 0."""
    out = y[routing.pos].sum(1)
    return torch.where(valid[:, None], out, 0.0)


def _expert_weights(e: int, n_routed: int, gate, up, down, gate_s, up_s,
                    down_s):
    if e < n_routed:
        return gate[e], up[e], down[e]
    inter = gate.shape[1]
    s = slice((e - n_routed) * inter, (e - n_routed + 1) * inter)
    return gate_s[s], up_s[s], down_s[:, s]


def grouped_expert_gemm_plain(x, routing: Routing, gate, up, down, gate_s,
                              up_s, down_s) -> torch.Tensor:
    """The plain version: a loop over the experts' sorted rows. h is
    rounded to x's dtype between the two products, as the kernel stores
    it; both products sum in float32."""
    n_routed = gate.shape[0]
    n_exp = routing.offsets.numel() - 1
    off = routing.offsets.tolist()
    y = torch.zeros(routing.src.numel(), down.shape[1], dtype=torch.float32,
                    device=x.device)
    for e in range(n_exp):
        lo, hi = off[e], off[e + 1]
        if lo == hi:
            continue
        wg, wu, wd = (w.float() for w in _expert_weights(
            e, n_routed, gate, up, down, gate_s, up_s, down_s))
        xe = x[routing.src[lo:hi].long()].float()
        h = (F.silu(xe @ wg.T) * (xe @ wu.T)).to(x.dtype).float()
        y[lo:hi] = (h @ wd.T) * routing.weight[lo:hi, None]
    return y


def tile_rows(tokens: int) -> int:
    """The kernel's rows a tile: 16 for a step of at most 256 tokens (a
    few rows an expert: bound by the weights' bytes), else 64."""
    return 16 if tokens <= 256 else 64


def grouped_expert_gemm(x: torch.Tensor, routing: Routing, gate, up, down,
                        gate_s, up_s, down_s) -> torch.Tensor:
    """Every pair's weighted expert output, (P, H) float32 in sorted order
    (rows of padding pairs undefined). x (T, H); gate, up (E, I, H); down
    (E, H, I); gate_s, up_s (S*I, H); down_s (H, S*I)."""
    if _build.on_cpu(x, 'grouped_expert_gemm'):
        return grouped_expert_gemm_plain(x, routing, gate, up, down, gate_s,
                                         up_s, down_s)
    for name, t in (('x', x), ('gate', gate), ('up', up), ('down', down),
                    ('gate_s', gate_s), ('up_s', up_s), ('down_s', down_s)):
        _build.check_cuda(t, f'grouped_expert_gemm {name}', torch.bfloat16)
    for name, t, dt in (('offsets', routing.offsets, torch.int32),
                        ('src', routing.src, torch.int32),
                        ('weight', routing.weight, torch.float32)):
        _build.check_cuda(t, f'grouped_expert_gemm {name}', dt)
    T, H = x.shape
    n_routed, inter = gate.shape[0], gate.shape[1]
    n_exp = routing.offsets.numel() - 1
    n_shared = n_exp - n_routed
    if (H % 64 or inter % 64 or n_exp > MAX_EXPERTS
            or tuple(up.shape) != tuple(gate.shape)
            or tuple(down.shape) != (n_routed, H, inter)
            or tuple(gate_s.shape) != (n_shared * inter, H)
            or tuple(down_s.shape) != (H, n_shared * inter)):
        raise ValueError('grouped_expert_gemm: the kernel takes widths that '
                         'are multiples of 64 and at most '
                         f'{MAX_EXPERTS} experts, got x {tuple(x.shape)}, '
                         f'gate {tuple(gate.shape)}, down '
                         f'{tuple(down.shape)}, shared {tuple(gate_s.shape)}')
    P = routing.src.numel()
    bm = tile_rows(T)
    tiles = -(-P // bm) + n_exp     # the static worst case
    h = torch.empty(P, inter, dtype=torch.bfloat16, device=x.device)
    y = torch.empty(P, H, dtype=torch.float32, device=x.device)
    st = _build.stream(x.device)
    with _build.device_of(x.device):
        err = _lib().mec_expert_gate_up(
            x.data_ptr(), routing.src.data_ptr(), routing.offsets.data_ptr(),
            gate.data_ptr(), up.data_ptr(), gate_s.data_ptr(),
            up_s.data_ptr(), n_routed, n_exp, H, inter, tiles, bm,
            h.data_ptr(), st)
        _build.check_error(err, 'grouped_expert_gemm gate_up')
        err = _lib().mec_expert_down(
            h.data_ptr(), routing.offsets.data_ptr(),
            routing.weight.data_ptr(), down.data_ptr(), down_s.data_ptr(),
            n_routed, n_exp, inter, H, tiles, bm, y.data_ptr(), st)
    _build.check_error(err, 'grouped_expert_gemm down')
    _build.count_launch(grouped_expert_gemm)
    return y


grouped_expert_gemm.launches = 0
