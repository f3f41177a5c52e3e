"""CUDA graphs of the engine's device steps, one a (step, argument shapes
and dtypes): the port's counterpart of the JAX engine's one jit a bucket.

A tri-modal step issues ~2,000-2,500 launches, each costing the host more
than the card spends on most of them; a graph replays them all with one
launch. EmotionEngine.warmup captures the tri-modal step at every batch
bucket and sequence bucket it warms, after one eager call at the same
shapes (the kernels' constant tables, K7's pointer tables and the
cuBLASLt plans are built then, outside the capture). _run looks up the
step and its arguments' shapes and dtypes and replays a graph where one
exists; any other call runs eagerly.

Each replica keeps its own StepGraphs. Its graphs share one memory pool,
so the pool holds about what the largest graph needs, not the sum. That
is safe because replays never overlap (one lock, one stream) and every
graph's static output stays referenced: a later capture may put its
temporaries where an earlier graph's output lies, but that output is
cloned before any other replay can run.

The kernel wrappers' .launches count calls that launch on the card: a
capture notes its calls without counting them (ops/_build.counting_calls)
and every replay adds them.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

from mec_tpu_torch.ops import _build


def signature(args) -> tuple:
    """The lookup key of a step's device arguments: each tensor's shape
    and dtype, in the arguments' nesting (a wire is a tuple)."""
    if isinstance(args, torch.Tensor):
        return tuple(args.shape), args.dtype
    return tuple(signature(a) for a in args)


def _flat(args) -> Iterator[torch.Tensor]:
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        else:
            yield from _flat(a)


class Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]      # the static inputs, flattened
    output: torch.Tensor            # the static output
    calls: Dict[Any, int]           # kernel wrapper -> calls a replay


class StepGraphs:
    """One replica's captured steps, by (step name, signature)."""

    def __init__(self):
        self._graphs: Dict[tuple, Graph] = {}
        self._lock = threading.Lock()
        self._pool = self._stream = None

    def __len__(self) -> int:
        return len(self._graphs)

    def get(self, step: str, args) -> Optional[Graph]:
        return self._graphs.get((step, signature(args)))

    def capture(self, step: str, fn: Callable, args) -> None:
        """Capture fn(*args) (the step method, already run eagerly at
        these shapes) with args as its static inputs, on their card."""
        device = next(_flat(args)).device
        with torch.cuda.device(device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(device)
            # torch.cuda.graph's capture without its empty_cache() (and
            # the gc.collect() of some torch versions): they free nothing
            # the capture needs and took up to 0.14 s each a capture on
            # the card's host
            torch.cuda.synchronize(device)
            graph = torch.cuda.CUDAGraph()
            with _build.counting_calls() as calls, \
                    torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self._pool)
                try:
                    out = fn(*args)
                finally:
                    graph.capture_end()
        self._graphs[step, signature(args)] = Graph(graph, list(_flat(args)),
                                                    out, calls)

    def replay(self, g: Graph, args) -> torch.Tensor:
        """g's output for args (device tensors of g's signature), a fresh
        tensor. Writing the static inputs, the replay and the clone hold
        the lock, so two threads never interleave them; all three go on
        the current stream, so the clone is ordered before the next
        caller's writes."""
        with self._lock:
            for static, a in zip(g.inputs, _flat(args)):
                static.copy_(a)
            g.graph.replay()
            out = g.output.clone()
        _build.add_launches(g.calls)
        return out

    def clear(self) -> None:
        with self._lock:
            self._graphs.clear()
