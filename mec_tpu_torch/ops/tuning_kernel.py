"""K2 tuning_select: the selection phase of the tuning estimator.

The counterpart of mec_tpu/ops/pallas_tuning.py. Per clip row of K pitch
candidates: the masked median of the magnitudes, sel = mags >= median &
pitch > 0, a 100-bin histogram of the selected residuals against the
ceil-to-f32 edge table, the first argmax, and whether anything was
selected. Integer and compare work only, so the kernel
(csrc/tuning_select.cu) and the plain version are bit-exact against the
reference.

The wrapper runs the plain version for a CPU tensor and launches the
kernel for a CUDA tensor, or raises; `tuning_select.launches` counts
kernel launches.

The kernel launches one thread block cluster per clip: `cluster_split(B)`
blocks each stream a slice of the row (`slot_slices`) and keep only the
candidates, block 0 gathers them and selects. The geometry and the
shared-memory budget behind MAX_K are computed here, handed to the C
interface, and pinned by the CPU tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from mec_tpu_torch.ops import _build

N_HIST_BINS = 100
_BIG = float(np.finfo(np.float32).max)
# Every block of the cluster holds room for all K slots' order keys and
# residuals (8 B a slot: block 0 gathers the candidates, and at worst
# every slot is one). The H100 grants a block 227 KB of shared memory;
# the kernel's own arrays (the 4096-bin digit histogram, the short list
# of 2048 keys, the bin histogram, edges, scratch) take at most
# STATIC_SMEM_BYTES of it.
SMEM_LIMIT_BYTES = 232_448
STATIC_SMEM_BYTES = 26_112
SLOT_BYTES = 8
MAX_K = 25_000
MAX_SPLIT = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def hist_edges_ceil32(n_bins: int = N_HIST_BINS) -> np.ndarray:
    """The ceil-to-f32 histogram edges of
    mec_tpu/ops/audio_features.py::_hist_edges_ceil32 (copied): for an
    f32 residual r, r >= e (f64 linspace edge) iff r >= ceil32(e)."""
    edges64 = np.linspace(-0.5, 0.5, n_bins + 1)
    ceil32 = edges64.astype(np.float32)
    low = ceil32.astype(np.float64) < edges64
    ceil32[low] = np.nextafter(ceil32[low], np.float32(np.inf),
                               dtype=np.float32)
    return ceil32


@functools.lru_cache(maxsize=None)
def _edges(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hist_edges_ceil32()).to(device)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library()
    lib.mec_tuning_select.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P]
    lib.mec_tuning_select.restype = _I
    return lib


def cluster_split(B: int) -> int:
    """Blocks a clip (the cluster's size): the most of 8, 4, 2 or 1 that
    still puts every cluster of a batch of B on the card at once. A block
    holds the whole row's slots in shared memory, so an SM runs one
    block: 8 blocks a clip up to 16 clips, 4 up to 33 (batch 32 fills
    128 of the 132 SMs), 2 up to 66."""
    for split in (8, 4, 2):
        if B * split <= _build.SM_COUNT:
            return split
    return 1


def slot_slices(K: int, split: int):
    """[begin, end) of the slots that the block of each rank streams:
    equal slices of ceil(K / split), the last ones shorter or empty."""
    size = -(-K // split)
    return [(min(r * size, K), min((r + 1) * size, K)) for r in range(split)]


def smem_bytes(K: int) -> int:
    """Shared memory a block of the kernel needs for a row of K slots."""
    return SLOT_BYTES * K + STATIC_SMEM_BYTES


def _order_keys(values: torch.Tensor) -> torch.Tensor:
    """Order-preserving uint32 keys of f32 values, held in int64:
    negative floats -> ~bits, others -> bits | 0x80000000."""
    bits = values.contiguous().view(torch.int32).to(torch.int64)
    u = bits & 0xFFFFFFFF
    return torch.where(bits < 0, 0xFFFFFFFF - u, u | 0x80000000)


def _key_values(keys: torch.Tensor) -> torch.Tensor:
    u = torch.where(keys >= 0x80000000, keys ^ 0x80000000, 0xFFFFFFFF - keys)
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)     # as signed int32 bits
    return u.to(torch.int32).view(torch.float32)


def _kth_smallest(values: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th smallest (0-based) per row: 32 binary-search passes over
    the key space (audio_features._kth_smallest)."""
    key = _order_keys(values)
    lo = torch.zeros(values.shape[0], dtype=torch.int64, device=values.device)
    hi = torch.full_like(lo, 0xFFFFFFFF)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        found = (key <= mid[:, None]).sum(dim=-1) >= k + 1
        lo, hi = torch.where(found, lo, mid + 1), torch.where(found, mid, hi)
    return _key_values(lo)


def tuning_select_plain(mags: torch.Tensor, residual: torch.Tensor,
                        pitches: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch transcription of audio_features._masked_median plus the
    count_chunk edge-differencing histogram and first argmax."""
    mask = pitches > 0
    filled = torch.where(mask, mags, _BIG)
    k = mask.sum(dim=-1)
    lo = torch.clamp((k - 1) // 2, min=0)
    hi = torch.clamp(k // 2, min=0)
    v_lo = _kth_smallest(filled, lo)
    cnt_le = (filled <= v_lo[:, None]).sum(dim=-1)
    nxt = torch.where(filled > v_lo[:, None], filled, _BIG).amin(dim=-1)
    v_hi = torch.where(cnt_le >= hi + 1, v_lo, nxt)
    med = torch.where(k > 0, 0.5 * (v_lo + v_hi), 0.0)
    sel = (mags >= med[:, None]) & mask

    edges = _edges(mags.device)
    r = residual[..., None]
    s3 = sel[..., None]
    chunk = 20
    counts = []
    for c in range(N_HIST_BINS // chunk):
        ge = r >= edges[c * chunk:(c + 1) * chunk + 1]    # (B, K, 21)
        hit = s3 & ge[..., :-1] & ~ge[..., 1:]
        counts.append(hit.sum(dim=1))                     # (B, 20)
    counts = torch.cat(counts, dim=-1)
    best = torch.argmax(counts, dim=-1).to(torch.int32)  # first max
    return best, sel.any(dim=-1)


def tuning_select(mags: torch.Tensor, residual: torch.Tensor,
                  pitches: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, K) float32 candidates -> (best_bin (B,) int32, has_any (B,) bool).

    Candidates with pitch 0 are masked out; residuals are the folded
    log2 residuals in [-0.5, 0.5), computed by the caller; magnitudes
    are finite."""
    if mags.dim() != 2 or residual.shape != mags.shape \
            or pitches.shape != mags.shape:
        raise ValueError('tuning_select: mags, residual, pitches must share '
                         f'one (B, K) shape, got {tuple(mags.shape)}, '
                         f'{tuple(residual.shape)}, {tuple(pitches.shape)}')
    if _build.on_cpu(mags, 'tuning_select'):
        return tuning_select_plain(mags, residual, pitches)
    for name, t in (('mags', mags), ('residual', residual),
                    ('pitches', pitches)):
        _build.check_cuda(t, f'tuning_select {name}', torch.float32)
    B, K = mags.shape
    if K > MAX_K:
        raise ValueError(f'tuning_select: K={K} exceeds the kernel\'s '
                         f'shared-memory row of {MAX_K} candidates '
                         f'({smem_bytes(K)} of {SMEM_LIMIT_BYTES} bytes)')
    best = torch.empty(B, dtype=torch.int32, device=mags.device)
    has = torch.empty(B, dtype=torch.bool, device=mags.device)
    with _build.device_of(mags.device):
        err = _lib().mec_tuning_select(
            mags.data_ptr(), residual.data_ptr(), pitches.data_ptr(), B, K,
            cluster_split(B), _edges(mags.device).data_ptr(), best.data_ptr(),
            has.data_ptr(),
            _build.stream(mags.device))
    _build.check_error(err, 'tuning_select')
    _build.count_launch(tuning_select)
    return best, has


tuning_select.launches = 0
