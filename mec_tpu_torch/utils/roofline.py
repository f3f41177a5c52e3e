"""Roofline helpers on the H100: data-sheet peaks, chain timers on CUDA
graphs, the measured memory rate and a traffic model of one call.

The counterpart of mec_tpu/utils/roofline.py. The JAX module times a
stage as a fori_loop chain inside one jit call and models its traffic
from XLA's buffer assignment; eager PyTorch has neither, so:

- `chain_wall_ms` captures k chained calls into one CUDA graph and
  replays it: the device runs the k calls back to back, without the
  wrappers' host work between them, and a graph replays every launch it
  captured, so nothing is hoisted or dropped as XLA may. `chain_slope_ms`
  keeps the JAX slope over two chain lengths, which cancels the constant
  cost of a replay (the graph launch and the synchronize).
- `measure_hbm_gbps` reads a seeded fp32 array once a call with one
  reduction, by the slope of two graph chains, and returns 10^9 bytes per
  second. (The JAX function reads size_mb MiB and divides size_mb / 1024:
  GiB/s under the name GB/s, ROADMAP C14.)
- `hbm_traffic_bytes(fn, *args)` counts one eager call through a
  TorchDispatchMode: what the call reads from outside, what it returns,
  and every tensor it makes in between.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM data sheet (one card, dense rates, at the 700 W power
# limit): device memory bytes/s, fp32 FLOP/s outside the tensor cores,
# bf16 tensor-core FLOP/s, int8 tensor-core OP/s
PEAKS = {'memory': 3.35e12, 'fp32': 67e12, 'bf16_tc': 989e12,
         'int8_tc': 1979e12}


def chain_wall_ms(call: Callable, k: int, reps: int = 3,
                  device='cuda') -> float:
    """Best wall time (ms) of k chained calls of `call(eps)`.

    `eps` is a 0-d float32 zero on `device`, the argument of the JAX
    chain's body, where it keeps XLA from hoisting the stage out of the
    loop. A graph replays every launch it captured, so a call may ignore
    it.

    On a CUDA device: one eager call first, so every kernel's first-call
    work (function attributes, constant tables, K7's pointer tables, the
    library handles) happens before capture, where a synchronous copy is
    illegal; then k calls captured into one torch.cuda.CUDAGraph, one
    replay to warm up and `reps` synchronized replays. Each call's
    outputs are dropped before the next is captured, so the graph's pool
    reuses their memory: a chain holds one call's outputs, not k. A call
    that cannot be captured raises torch's capture error; nothing falls
    back to eager launches. On the CPU: k calls in a plain loop under
    time.perf_counter."""
    dev = torch.device(device)
    eps = torch.zeros((), dtype=torch.float32, device=dev)
    call(eps)
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph):
            for _ in range(k):
                call(eps)

        def run():
            graph.replay()
            torch.cuda.synchronize(dev)
        run()
    else:
        def run():
            for _ in range(k):
                call(eps)
    best = float('inf')
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def chain_slope_ms(call: Callable, k1: int = 40, k2: int = 160,
                   reps: int = 3, device='cuda') -> float:
    """Per-call time via the SLOPE of two chain lengths:
    (wall(k2) - wall(k1)) / (k2 - k1) cancels the constant part of a
    chain's wall (on the card the graph launch and the synchronize)."""
    w1 = chain_wall_ms(call, k1, reps, device)
    w2 = chain_wall_ms(call, k2, reps, device)
    return max((w2 - w1) / (k2 - k1), 1e-6)


def measure_hbm_gbps(size_mb: int = 256, reps: int = 3,
                     device='cuda') -> float:
    """The memory rate the card sustains reading, in 10^9 bytes/s.

    One `x.sum()` a call over size_mb MiB of seeded fp32 noise, timed by
    chain_slope_ms. A single reduction reads the array once; JAX's
    abs(x + eps) would make eager torch write and read a temporary of the
    same size. On the CPU it runs the same way; its value is the host's,
    not a device's."""
    n = size_mb * 2 ** 20 // 4
    gen = torch.Generator(device).manual_seed(0)
    x = torch.randn(n, generator=gen, device=device)
    step_ms = chain_slope_ms(lambda eps: x.sum(), reps=reps, device=device)
    return n * 4 / 1e9 / (step_ms * 1e-3)


def _storage(t: torch.Tensor):
    s = t.untyped_storage()
    return s.data_ptr(), s.nbytes()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Traffic(TorchDispatchMode):
    """Records every dispatched op's operand and result storages. Results
    are held until the mode exits, so the allocator cannot hand a freed
    temporary's memory to a later one under the same address."""

    def __init__(self):
        super().__init__()
        self.outside: Dict[int, int] = {}   # storages read, made elsewhere
        self.made: Dict[int, int] = {}      # storages of ops' results
        self.logical = 0
        self._held = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        read = set()
        for t in ins:
            ptr, nb = _storage(t)
            read.add(ptr)
            if ptr not in self.made:
                self.outside.setdefault(ptr, nb)
        for t in outs:
            ptr, nb = _storage(t)
            if ptr not in self.outside:
                self.made.setdefault(ptr, nb)
        # an op that may return a view (reshape, to, contiguous) moves no
        # bytes when it did; when it copied, its result is a new storage
        if not (func.is_view and all(_storage(t)[0] in read for t in outs)):
            self.logical += sum(t.numel() * t.element_size()
                                for t in ins + outs)
        self._held.append(outs)
        return out


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """FlopCounterMode's formula for torch._int_mm: a matmul's 2*m*k*n."""
    m, k = a_shape
    return 2 * m * k * b_shape[1]


def hbm_traffic_bytes(fn: Callable, *args) -> Dict[str, float]:
    """A physical memory-traffic model of one eager call fn(*args), in
    bytes, with the JAX function's keys:

    - arg_bytes: the unique storages the call reads and did not make: its
      tensor arguments, and what it reaches besides (a module's
      parameters and buffers, tables held in a closure), each read at
      least once;
    - out_bytes: the unique storages of the tensors it returns;
    - temp_bytes: the storages of every dispatched op's results that are
      neither read from outside nor returned. Eager torch has no arena to
      reuse, so each is written once and read at least once;
    - model_bytes = arg + out + 2 * temp;
    - logical_bytes: the operand and result bytes of every dispatched op
      that did not return a view of its operands (each consumer counts a
      full read);
    - flops: torch.utils.flop_counter.FlopCounterMode's count (matmuls,
      convolutions, attention; torch._int_mm counted as a matmul).
      Elementwise work is not counted.

    What this cannot see: a hand-written kernel is called through ctypes,
    not dispatched, so the tensors it reads, what it writes into them and
    its arithmetic are missing from logical_bytes and flops, and a table
    only it reads is missing from arg_bytes. Its output buffers,
    allocated through torch.empty, are counted (as temp or out). Every
    result is held until the call ends, so the call's peak memory is the
    sum of its temporaries."""
    from torch.utils.flop_counter import FlopCounterMode
    traffic = _Traffic()
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten._int_mm: _int_mm_flops}) as flops, traffic:
        out = fn(*args)
    reads = dict(traffic.outside)
    for t in _tensors(args):
        reads.setdefault(*_storage(t))
    outs = dict(_storage(t) for t in _tensors(out))
    arg = float(sum(reads.values()))
    res = float(sum(outs.values()))
    tmp = float(sum(nb for ptr, nb in traffic.made.items()
                    if ptr not in reads and ptr not in outs))
    return {
        'model_bytes': arg + res + 2.0 * tmp,
        'arg_bytes': arg,
        'out_bytes': res,
        'temp_bytes': tmp,
        'logical_bytes': float(traffic.logical),
        'flops': float(flops.get_total_flops()),
    }
