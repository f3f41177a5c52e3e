"""Serving-loop stage timing and the device trace.

A copy of mec_tpu/utils/profiling.py's StageTimer and process-wide
`timer` (that module cannot be imported here: importing mec_tpu imports
jax): per-stage wall-clock spans aggregated into percentile summaries.
`device_trace` is the counterpart of its jax.profiler trace, on
torch.profiler.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


class StageTimer:
    """Thread-safe named-span recorder: p50/p90/p99/mean per stage."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1000.0)

    def record(self, name: str, ms: float) -> None:
        """Record an externally-measured duration (same aggregation as
        span(); for waits whose start lives on another thread, e.g. the
        batcher's submit->batch-formation queue time)."""
        with self._lock:
            buf = self._spans[name]
            buf.append(ms)
            if len(buf) > self.capacity:
                del buf[:len(buf) - self.capacity]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            for name, buf in self._spans.items():
                if not buf:
                    continue
                s = sorted(buf)
                n = len(s)
                out[name] = {
                    'count': n,
                    'mean_ms': sum(s) / n,
                    'p50_ms': s[n // 2],
                    'p90_ms': s[min(n - 1, int(n * 0.9))],
                    'p99_ms': s[min(n - 1, int(n * 0.99))],
                }
        return out

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()


timer = StageTimer()  # process-wide default


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[object]:
    """torch.profiler trace of the block, written into log_dir (default
    <temp dir>/mec_trace, the JAX package's /tmp/mec_trace) as
    TensorBoard's profiler plugin and Perfetto read it
    (tensorboard_trace_handler: <host>_<pid>.<ms>.pt.trace.json). CPU
    activities always, CUDA activities (the kernels, with their device
    times) when a card is present. Yields the profile object."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), 'mec_trace')
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
