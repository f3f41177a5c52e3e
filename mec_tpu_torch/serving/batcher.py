"""Micro-batching queue: concurrent requests share one device dispatch.

A copy of mec_tpu/serving/batcher.py with its imports pointed at the
port (importing mec_tpu imports jax, which the card's machine lacks).
The queue is host code and unchanged; the TPU-era measurements quoted
below are the original's and say nothing about the H100.

The serving inversion of the reference's concurrency model (SURVEY.md §5):
instead of N forked gunicorn workers each running batch-1 inference on
their own model copies (reference gunicorn_config.py:16-18), many WSGI
threads submit into one queue; a collector drains it every
Config.BATCH_TIMEOUT_S (or when the largest bucket fills) and runs ONE
batched compiled graph for everything pending, padding up to the bucket
sizes the engine has already compiled.

Latency math: sparse traffic pays at most one timeout slice (default
3 ms) of added queueing delay. While NEW requests keep arriving within
each slice, the linger extends adaptively up to Config.BATCH_MAX_LINGER_S
(default 20 ms) so sustained concurrency coalesces into deeper device
batches — measured on the v5e HTTP path this RAISED throughput and CUT
p50 at 32 clients (fewer ~30 ms dispatch round trips; BASELINE.md
"Concurrent HTTP serving"). Under load the batch effect dominates — 32
concurrent tri-modal requests cost one dispatch instead of 32.

Pipelining: each batch runs on a small worker pool (depth
Config.BATCH_PIPELINE_DEPTH, default 2) instead of inline on the
collector, so host work for batch N+1 (file decode, tokenize, wire
encode) overlaps the device round trip of batch N — on the remote-tunnel
deployment that round trip is upload + compute + a ~30 ms fetch RTT. A
semaphore bounds in-flight batches at the pool depth; while every slot
is busy the collector keeps queueing, so coalescing under load is
preserved (the next batch forms from everything that arrived meanwhile).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from mec_tpu_torch.config import Config
from mec_tpu_torch.utils.profiling import timer


class BatchOverloaded(RuntimeError):
    """Raised by submit() when the queue's max_pending bound is hit —
    load shedding: callers (the webapp) surface 503 + Retry-After
    instead of queueing work the device cannot catch up on."""


class BatchQueue:
    """Coalesces submit(item) calls into fn(list_of_items) invocations."""

    def __init__(self, fn: Callable[[Sequence[Any]], List[Any]],
                 max_batch: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 name: str = 'batch',
                 pipeline_depth: Optional[int] = None,
                 max_linger_s: Optional[float] = None,
                 max_pending: Optional[int] = None):
        self.fn = fn
        self.max_batch = max_batch or Config.BATCH_BUCKETS[-1]
        self.timeout_s = (Config.BATCH_TIMEOUT_S if timeout_s is None
                          else timeout_s)
        # adaptive cap: total linger while arrivals keep landing (see
        # Config.BATCH_MAX_LINGER_S); never below timeout_s, so a
        # caller-raised timeout keeps its exact legacy semantics
        self.max_linger_s = max(
            self.timeout_s,
            Config.BATCH_MAX_LINGER_S if max_linger_s is None
            else max_linger_s)
        self.name = name
        # load-shedding bound on queued-not-yet-batched items; <=0 means
        # unbounded (in-flight batches are separately bounded by the
        # pipeline-depth semaphore)
        self.max_pending = (Config.BATCH_MAX_PENDING if max_pending is None
                            else max_pending)
        self.pipeline_depth = max(1, pipeline_depth
                                  or Config.BATCH_PIPELINE_DEPTH)
        self._lock = threading.Lock()
        self._pending: List[Tuple[Any, Future, float]] = []
        self._wakeup = threading.Event()
        self._full = threading.Event()   # largest bucket reached
        self._stopped = False
        self._slots = threading.Semaphore(self.pipeline_depth)
        self._exec = ThreadPoolExecutor(max_workers=self.pipeline_depth,
                                        thread_name_prefix=f'batchrun-{name}')
        self._thread = threading.Thread(target=self._loop,
                                        name=f'batcher-{name}', daemon=True)
        self._thread.start()
        self.batches_run = 0
        self.items_run = 0

    def submit(self, item: Any) -> Any:
        """Blocking: returns fn's result for this item."""
        fut: Future = Future()
        with self._lock:
            if self._stopped:
                raise RuntimeError('batcher stopped')
            if 0 < self.max_pending <= len(self._pending):
                raise BatchOverloaded(
                    f'{self.name}: {len(self._pending)} requests queued '
                    f'(max_pending={self.max_pending})')
            self._pending.append((item, fut, time.perf_counter()))
            full = len(self._pending) >= self.max_batch
        self._wakeup.set()
        if full:
            self._full.set()
        return fut.result()

    def overloaded(self) -> bool:
        """Cheap pre-admission probe: True when the pending bound is
        currently hit. Callers use it to skip optional work (e.g.
        request-thread decode) for requests that are about to be shed;
        submit() re-checks under the lock (authoritative)."""
        return 0 < self.max_pending <= len(self._pending)

    def backlogged(self) -> bool:
        """Softer watermark than overloaded(): True once more than one
        full batch is already queued. The webapp stops request-thread
        predecode above this level — each predecoded tri-modal payload
        holds ~0.5 MB of decoded tensors, so a deep queue of them is a
        memory-pressure mode of its own on a small host — while the
        batch about to form still gets predecoded arrays."""
        return len(self._pending) > self.max_batch

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
        self._wakeup.set()
        self._full.set()   # don't sit out a long linger during shutdown
        self._thread.join(timeout=10)
        # Shut the pool down only once the collector has actually exited:
        # shutting it while the collector is still blocked in
        # _slots.acquire() would make its next _exec.submit raise. (The
        # collector tolerates that race too — see _loop — but a live
        # daemon collector with a live pool is strictly safer than a dead
        # one with stranded futures.)
        if not self._thread.is_alive():
            self._exec.shutdown(wait=True)

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            self._wakeup.wait()
            with self._lock:
                if self._stopped and not self._pending:
                    return
                has_work = bool(self._pending)
                if not has_work:
                    self._wakeup.clear()
            if not has_work:
                continue
            # linger so concurrent submitters join this batch — cut
            # short as soon as the largest bucket fills (the docstring's
            # 'or when the largest bucket fills' contract; a full bucket
            # gains nothing from waiting out the timeout). Adaptive
            # extension: while NEW arrivals landed during the last
            # timeout_s slice, keep lingering up to max_linger_s total —
            # sustained concurrency coalesces into deeper device batches
            # (fewer dispatch round trips) while sparse traffic still
            # flushes after one slice.
            if self.timeout_s > 0:
                deadline = time.monotonic() + self.max_linger_s
                with self._lock:
                    n_prev = len(self._pending)
                    full = n_prev >= self.max_batch or self._stopped
                    if not full:
                        self._full.clear()
                while not full:
                    remaining = deadline - time.monotonic()
                    self._full.wait(min(self.timeout_s,
                                        max(remaining, 0.0)))
                    with self._lock:
                        n_now = len(self._pending)
                        full = (n_now >= self.max_batch or self._stopped)
                    if full or n_now == n_prev:
                        break  # bucket full, stopping, or arrivals idle
                    if time.monotonic() >= deadline:
                        break  # linger cap reached
                    n_prev = n_now
            # wait for a pipeline slot BEFORE forming the batch: while
            # every worker is busy, arrivals keep coalescing into one
            # larger batch instead of many early small ones
            self._slots.acquire()
            with self._lock:
                batch = self._pending[:self.max_batch]
                del self._pending[:len(batch)]
                # never clear once stopped: stop() set the event AFTER
                # setting _stopped, and clearing it here would strand the
                # next wait() forever (stop() would hang on join)
                if not self._pending and not self._stopped:
                    self._wakeup.clear()
            if not batch:
                self._slots.release()
                continue
            try:
                self._exec.submit(self._run_batch, batch)
            except RuntimeError:
                # executor already shut down (stop() raced this batch) —
                # run inline so callers blocked in fut.result() still get
                # an answer instead of hanging forever
                self._run_batch(batch)

    def _run_batch(self, batch: List[Tuple[Any, Future, float]]) -> None:
        try:
            # per-item queue wait (submit -> batch start) + per-batch run
            # time land in the process StageTimer: surfaced by
            # /api/metrics and examples/load_http.py's phase breakdown
            now = time.perf_counter()
            for _, _, t_sub in batch:
                timer.record(f'batcher.{self.name}.queue_wait_ms',
                             (now - t_sub) * 1e3)
            items = [b[0] for b in batch]
            try:
                with timer.span(f'batcher.{self.name}.run'):
                    results = self.fn(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f'batch fn returned {len(results)} results '
                        f'for {len(items)} items')
                for (_, fut, _t), res in zip(batch, results):
                    fut.set_result(res)
            except Exception as e:  # pragma: no cover - defensive
                for _, fut, _t in batch:
                    if not fut.done():
                        fut.set_exception(e)
            with self._lock:
                self.batches_run += 1
                self.items_run += len(batch)
        finally:
            self._slots.release()


class EngineBatcher:
    """Per-modality batch queues over an EmotionEngine."""

    def __init__(self, engine, timeout_s: Optional[float] = None,
                 max_linger_s: Optional[float] = None):
        self.engine = engine
        self.text = BatchQueue(lambda ts: engine.predict_texts(list(ts)),
                               timeout_s=timeout_s, name='text',
                               max_linger_s=max_linger_s)
        self.speech = BatchQueue(
            lambda ps: engine.predict_speech_paths(list(ps)),
            timeout_s=timeout_s, name='speech', max_linger_s=max_linger_s)
        self.image = BatchQueue(
            lambda ps: engine.predict_image_paths(list(ps)),
            timeout_s=timeout_s, name='image', max_linger_s=max_linger_s)
        self.multimodal = BatchQueue(
            lambda rs: engine.predict_multimodal_batch(list(rs)),
            timeout_s=timeout_s, name='multimodal',
            max_linger_s=max_linger_s)

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {name: {'batches': q.batches_run, 'items': q.items_run}
                for name, q in (('text', self.text),
                                ('speech', self.speech),
                                ('image', self.image),
                                ('multimodal', self.multimodal))}

    def stop(self) -> None:
        for q in (self.text, self.speech, self.image, self.multimodal):
            q.stop()
