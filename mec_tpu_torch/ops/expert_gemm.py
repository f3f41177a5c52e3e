"""One dropless top-k mixture-of-experts layer with shared experts
(Moonlight-16B-A3B's deepseek_v3 layer), from the residual stream x to
x + the layer's output, in five launches on a card: the router, the sort,
the grouped expert GEMM's two, and the combine.

expert_router() normalises x (the post-attention RMSNorm) into h and
chooses each token's k experts by noaux_tc routing in float32, with their
weights. sort_pairs() sorts the layer's token-expert pairs by expert on
the device: each real token's k routed pairs and one pair with each
shared expert (weight 1), padding tokens none; it also adds the layer's
routing counters (experts given a real token, real token-expert pairs)
into the step's. Nothing is read back to the host, so the step stays
capturable in a CUDA graph. grouped_expert_gemm() computes every pair's
weighted SwiGLU expert output, (P, H) float32 in sorted order.
combine_residual() sums each token's pairs in float32 in slot order (no
atomics: a replay repeats eager bit for bit) and adds the sum, rounded to
x's dtype, to x.

For a CUDA tensor each wrapper launches csrc/expert_routing.cu (router,
sort, combine) or csrc/grouped_expert_gemm.cu (gate and up with SwiGLU
in the epilogue; down with the routing weight in the epilogue), counted
once a call in its `.launches`, or raises. For a CPU tensor it runs its
plain version: the PyTorch composition the kernels replace
(expert_router_plain, route() and its counters, grouped_expert_gemm_plain,
combine() and the add).

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
_F = ctypes.c_float
# largest expert count the kernels take (csrc/grouped_expert_gemm.cu,
# csrc/expert_routing.cu)
MAX_EXPERTS = 255
# the router scores exactly this many routed experts, and takes at most
# MAX_TOP_K a token; a token has at most MAX_PAIRS pairs (routed + shared)
ROUTER_EXPERTS = 64
MAX_ROUTER_WIDTH = 2048
MAX_TOP_K = 8
MAX_PAIRS = 32
# a block's shared memory on the H100 (the router holds its tokens' h)
MAX_SMEM = 232448


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library()
    lib.mec_expert_gate_up.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                       _I, _I, _I, _I, _P, _P]
    lib.mec_expert_gate_up.restype = _I
    lib.mec_expert_down.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _P, _P]
    lib.mec_expert_down.restype = _I
    lib.mec_expert_router.argtypes = [_P, _P, _P, _P, _I, _I, _F, _I, _I, _F,
                                      _I, _P, _P, _P, _P]
    lib.mec_expert_router.restype = _I
    lib.mec_expert_sort.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                    _P, _P, _P, _P]
    lib.mec_expert_sort.restype = _I
    lib.mec_expert_combine.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P, _P]
    lib.mec_expert_combine.restype = _I
    return lib


class Routing(NamedTuple):
    offsets: torch.Tensor   # (E + S + 1,) int32: sorted rows of each expert
    src: torch.Tensor       # (P,) int32: the token of each sorted pair
    weight: torch.Tensor    # (P,) float32: its routing weight
    pos: torch.Tensor       # (T, k + S) int64: each token's pairs' positions
    counts: torch.Tensor    # (E + S + 1,) int32: pairs an expert (+ padding)


def expert_router_plain(x: torch.Tensor, norm_w: torch.Tensor,
                        gate_w: torch.Tensor, bias: torch.Tensor, eps: float,
                        k: int, norm_topk_prob: bool, scale: float):
    """The plain version: models/moonlight.py::rms_norm (normalised in
    float32, rounded to x's dtype, then scaled), then noaux_tc routing
    with n_group = topk_group = 1: s = sigmoid(h W_g^T) in float32, the
    top k of s + bias (the bias chooses and never weights), w = scale *
    s_top / sum(s_top) (without the sum unless norm_topk_prob)."""
    # imported here: models/moonlight.py imports this module
    from mec_tpu_torch.models.moonlight import rms_norm
    h = rms_norm(x, norm_w, eps)
    scores = torch.sigmoid(h.float() @ gate_w.float().T)
    idx = torch.topk(scores + bias.float(), k, -1).indices
    w = scores.gather(1, idx)
    if norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return h, idx, w * scale


def router_tokens(tokens: int) -> int:
    """The router's tokens a block: the fewest of 4, 8, 16 and 32 that
    cover the step's tokens in at most one block an SM, else 32 (a few
    tokens a block while the step is small, so its gate products spread
    over the card; 32 at b32 x 128, 128 blocks)."""
    for tb in (4, 8, 16, 32):
        if -(-tokens // tb) <= _build.SM_COUNT:
            return tb
    return 32


def expert_router(x: torch.Tensor, norm_w: torch.Tensor, gate_w: torch.Tensor,
                  bias: torch.Tensor, eps: float, k: int, norm_topk_prob: bool,
                  scale: float):
    """x (T, H) -> h (T, H) in x's dtype, the normed tokens the experts
    read; each token's k experts (T, k), highest biased score first (a tie
    to the lower index), and their float32 weights (T, k). norm_w (H,),
    gate_w (E, H), bias (E,). On a card one launch of
    csrc/expert_routing.cu, everything bf16 in and the experts int32."""
    if _build.on_cpu(x, 'expert_router'):
        return expert_router_plain(x, norm_w, gate_w, bias, eps, k,
                                   norm_topk_prob, scale)
    for name, t in (('x', x), ('norm_w', norm_w), ('gate_w', gate_w),
                    ('bias', bias)):
        _build.check_cuda(t, f'expert_router {name}', torch.bfloat16)
    T, H = x.shape
    tb = router_tokens(T)
    smem = tb * H * 2 + 2 * tb * ROUTER_EXPERTS * 4
    if (H % 128 or H > MAX_ROUTER_WIDTH
            or tuple(gate_w.shape) != (ROUTER_EXPERTS, H)
            or tuple(norm_w.shape) != (H,)
            or tuple(bias.shape) != (ROUTER_EXPERTS,)
            or not 0 < k <= MAX_TOP_K or smem > MAX_SMEM
            or any(t.data_ptr() % 16 for t in (x, norm_w, gate_w))):
        raise ValueError('expert_router: the kernel takes a width that is a '
                         f'multiple of 128 up to {MAX_ROUTER_WIDTH}, '
                         f'{ROUTER_EXPERTS} experts, at most '
                         f'{MAX_TOP_K} a token and 16-byte aligned rows, got '
                         f'x {tuple(x.shape)}, gate {tuple(gate_w.shape)}, '
                         f'k {k}')
    h = torch.empty_like(x)
    idx = torch.empty(T, k, dtype=torch.int32, device=x.device)
    w = torch.empty(T, k, dtype=torch.float32, device=x.device)
    with _build.device_of(x.device):
        err = _lib().mec_expert_router(
            x.data_ptr(), norm_w.data_ptr(), gate_w.data_ptr(),
            bias.data_ptr(), T, H, eps, k, int(bool(norm_topk_prob)), scale,
            tb, h.data_ptr(), idx.data_ptr(), w.data_ptr(),
            _build.stream(x.device))
    _build.check_error(err, 'expert_router')
    _build.count_launch(expert_router)
    return h, idx, w


expert_router.launches = 0


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


def sort_pairs(topk_idx: torch.Tensor, topk_w: torch.Tensor,
               valid: torch.Tensor, n_routed: int, n_shared: int,
               counters: torch.Tensor) -> Routing:
    """route()'s Routing of the layer's pairs, and the layer's routing
    counters added into counters (2,) int32: [routed experts given a real
    token, real token-expert pairs]. On a card one launch of
    csrc/expert_routing.cu (topk_idx int32, topk_w float32, valid bool)."""
    if _build.on_cpu(topk_idx, 'sort_pairs'):
        routing = route(topk_idx, topk_w, valid, n_routed, n_shared)
        per = routing.counts[:n_routed]
        counters += torch.stack([(per > 0).sum(), per.sum()]).to(torch.int32)
        return routing
    for name, t, dt in (('topk_idx', topk_idx, torch.int32),
                        ('topk_w', topk_w, torch.float32),
                        ('valid', valid, torch.bool),
                        ('counters', counters, torch.int32)):
        _build.check_cuda(t, f'sort_pairs {name}', dt)
    T, k = topk_idx.shape
    n_exp = n_routed + n_shared
    if (n_exp > MAX_EXPERTS or k + n_shared > MAX_PAIRS
            or tuple(topk_w.shape) != (T, k) or tuple(valid.shape) != (T,)
            or tuple(counters.shape) != (2,)):
        raise ValueError(f'sort_pairs: the kernel takes at most {MAX_EXPERTS}'
                         f' experts and {MAX_PAIRS} pairs a token, got '
                         f'{n_routed} + {n_shared} experts, topk '
                         f'{tuple(topk_idx.shape)}')
    dev = topk_idx.device
    counts = torch.empty(n_exp + 1, dtype=torch.int32, device=dev)
    offsets = torch.empty(n_exp + 1, dtype=torch.int32, device=dev)
    src = torch.empty(T * (k + n_shared), dtype=torch.int32, device=dev)
    weight = torch.empty(T * (k + n_shared), dtype=torch.float32, device=dev)
    pos = torch.empty(T, k + n_shared, dtype=torch.int64, device=dev)
    with _build.device_of(dev):
        err = _lib().mec_expert_sort(
            topk_idx.data_ptr(), topk_w.data_ptr(), valid.data_ptr(), T, k,
            n_routed, n_exp, counts.data_ptr(), offsets.data_ptr(),
            src.data_ptr(), weight.data_ptr(), pos.data_ptr(),
            counters.data_ptr(), _build.stream(dev))
    _build.check_error(err, 'sort_pairs')
    _build.count_launch(sort_pairs)
    return Routing(offsets, src, weight, pos, counts)


sort_pairs.launches = 0


def combine(y: torch.Tensor, routing: Routing, valid: torch.Tensor
            ) -> torch.Tensor:
    """(T, H) float32: each real token's pairs of y (P, H) summed in slot
    order; padding tokens 0."""
    out = y[routing.pos[:, 0]]
    for j in range(1, routing.pos.shape[1]):
        out = out + y[routing.pos[:, j]]
    return torch.where(valid[:, None], out, 0.0)


def combine_residual(x: torch.Tensor, y: torch.Tensor, routing: Routing,
                     valid: torch.Tensor) -> torch.Tensor:
    """x (T, H) + combine(y, routing, valid) rounded to x's dtype: the
    sum rounds once and the add once, as torch rounds x + out. On a card
    one launch of csrc/expert_routing.cu (x bf16, y float32, valid bool)."""
    if _build.on_cpu(x, 'combine_residual'):
        return x + combine(y, routing, valid).to(x.dtype)
    for name, t, dt in (('x', x, torch.bfloat16), ('y', y, torch.float32),
                        ('pos', routing.pos, torch.int64),
                        ('valid', valid, torch.bool)):
        _build.check_cuda(t, f'combine_residual {name}', dt)
    T, H = x.shape
    per = routing.pos.shape[1]
    if (H % 8 or per > MAX_PAIRS or y.shape[1] != H
            or tuple(routing.pos.shape) != (T, per)
            or tuple(valid.shape) != (T,)
            or any(t.data_ptr() % 16 for t in (x, y))):
        raise ValueError('combine_residual: the kernel takes a width that is '
                         f'a multiple of 8, at most {MAX_PAIRS} pairs a '
                         'token and 16-byte aligned rows, got x '
                         f'{tuple(x.shape)}, y {tuple(y.shape)}, pos '
                         f'{tuple(routing.pos.shape)}')
    out = torch.empty_like(x)
    with _build.device_of(x.device):
        err = _lib().mec_expert_combine(
            x.data_ptr(), y.data_ptr(), routing.pos.data_ptr(),
            valid.data_ptr(), T, H, per, out.data_ptr(),
            _build.stream(x.device))
    _build.check_error(err, 'combine_residual')
    _build.count_launch(combine_residual)
    return out


combine_residual.launches = 0


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
