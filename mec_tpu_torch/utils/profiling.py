"""Serving-loop stage timing and the device trace.

A copy of mec_tpu/utils/profiling.py's StageTimer and process-wide
`timer` (that module cannot be imported here: importing mec_tpu imports
jax): per-stage wall-clock spans aggregated into percentile summaries,
with the same summary(). The port's timer adds a total count and sum a
stage past the reservoir (totals()) and a span log, off by default:
while on (start_log()), every span and record is kept with its
perf_counter interval (the clock a profiler trace of the card is read
on), the thread's CPU time and id, its parent span and attributes.
With the log off, span() and record() add one flag test to the
aggregates' work.
`device_trace` is the counterpart of its jax.profiler trace, on
torch.profiler.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, List, NamedTuple, Optional


# the most records a span log keeps; later ones are only counted
LOG_CAPACITY = 1 << 20


class SpanRecord(NamedTuple):
    """One entry of the StageTimer's span log: a span() or a record().
    t0, t1 are time.perf_counter seconds (a record() covers
    [now - ms, now]); cpu_s the thread's time.thread_time() over the span
    (None for a record()); ident the thread's threading.get_ident()
    (the pthread id, whose low 32 bits a torch.profiler trace gives the
    thread's CUDA runtime calls on some threads, not on all, so a trace
    is matched to the log by time as well); parent the id of the
    innermost span open on the same thread (None at the top); attrs the
    span's keyword attributes; id its own, which a child's parent
    names."""
    name: str
    t0: float
    t1: float
    cpu_s: Optional[float]
    ident: int
    parent: Optional[int]
    attrs: Dict[str, Any]
    id: int


class _Span:
    """What StageTimer.span() returns: the context manager, which after
    its block holds t0, t1 (perf_counter seconds) and ms."""

    __slots__ = ('_timer', 'name', 'attrs', 't0', 't1', '_cpu0', '_id',
                 '_thread')

    def __init__(self, timer: 'StageTimer', name: str, attrs: Dict):
        self._timer, self.name, self.attrs = timer, name, attrs
        self._id = None

    def __enter__(self) -> '_Span':
        tm = self._timer
        if tm._logging:
            self._id = next(tm._ids)
            self._thread = tm._thread()
            self._thread.stack.append(self._id)
            self._cpu0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        tm, rec = self._timer, None
        if self._id is not None:
            cpu = time.thread_time() - self._cpu0
            th = self._thread
            th.stack.pop()
            rec = SpanRecord(self.name, self.t0, self.t1, cpu, th.ident,
                             th.stack[-1] if th.stack else None,
                             self.attrs, self._id)
        tm._add(self.name, (self.t1 - self.t0) * 1000.0, rec)
        return False

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1000.0


class StageTimer:
    """Thread-safe named-span recorder: p50/p90/p99/mean per stage over
    the last `capacity` samples of each, a count and sum per stage over
    every call since reset() (totals()), and, while switched on, a log
    of every span and record with its interval, thread and parent
    (start_log(), log())."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._spans: Dict[str, List[float]] = defaultdict(list)
        self._totals: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        self._logging = False
        self._records: List[SpanRecord] = []
        self.log_dropped = 0
        self._ids = itertools.count()
        self._local = threading.local()

    def span(self, name: str, **attrs) -> _Span:
        """Time the block under `name`; with the log on, also log it with
        `attrs` (a small dict the block may add to through the returned
        object's .attrs)."""
        return _Span(self, name, attrs)

    def record(self, name: str, ms: float) -> None:
        """Record an externally-measured duration (same aggregation as
        span(); for waits whose start lives on another thread, e.g. the
        batcher's submit->batch-formation queue time)."""
        rec = None
        if self._logging:
            t1 = time.perf_counter()
            th = self._thread()
            rec = SpanRecord(name, t1 - ms / 1000.0, t1, None, th.ident,
                             th.stack[-1] if th.stack else None, {},
                             next(self._ids))
        self._add(name, ms, rec)

    def _add(self, name: str, ms: float, rec: Optional[SpanRecord]) -> None:
        with self._lock:
            buf = self._spans[name]
            buf.append(ms)
            if len(buf) > self.capacity:
                del buf[:len(buf) - self.capacity]
            tot = self._totals[name]
            tot[0] += 1
            tot[1] += ms
            if rec is not None and self._logging:
                if len(self._records) < LOG_CAPACITY:
                    self._records.append(rec)
                else:
                    self.log_dropped += 1

    def _thread(self) -> threading.local:
        """The calling thread's id and the ids of the logged spans open
        on it (.stack), made at its first logged call."""
        th = self._local
        if not hasattr(th, 'stack'):
            th.stack, th.ident = [], threading.get_ident()
        return th

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

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Count and summed ms of every call of each name since reset(),
        never truncated (summary() keeps the last `capacity`)."""
        with self._lock:
            return {name: {'count': int(c), 'sum_ms': s}
                    for name, (c, s) in self._totals.items()}

    def start_log(self) -> None:
        """Start a new span log (the old records go) keeping the first
        LOG_CAPACITY records; later ones are counted in log_dropped."""
        with self._lock:
            self._records = []
            self.log_dropped = 0
            self._logging = True

    def stop_log(self) -> None:
        """Stop logging; log() keeps what was logged."""
        with self._lock:
            self._logging = False

    def log(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._records)

    def reset(self) -> None:
        """Clear the samples, the totals and the log's records (the log
        stays on or off)."""
        with self._lock:
            self._spans.clear()
            self._totals.clear()
            self._records = []
            self.log_dropped = 0


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
