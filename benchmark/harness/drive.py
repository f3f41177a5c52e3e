"""The window's drivers and the harness's spans.

A request is what the web app's request thread does with a tri-modal
upload: engine.predecode_multimodal(payload) in the request's thread,
then EngineBatcher.multimodal.submit(payload), which blocks until the
batch that carries it has run predict_multimodal_batch.

open loop: a scheduler thread hands each request to a worker thread at
its due time; its latency runs from the due time to its answer, so a
stall delays every later request too. closed loop: `clients` threads,
each sending its next request when its answer came.

Spans (traced runs only): 'decode' around predecode_multimodal in the
request thread, and, from wrappers put on the engine instance,
'dispatch' around predict_multimodal_batch and 'step' around each
_run('_trimodal_forward', ...) (copies in, the step, the rows back),
with the dispatch's row bucket.
"""

from __future__ import annotations

import concurrent.futures
import itertools
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

pc = time.perf_counter


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.data: Dict[str, List[tuple]] = defaultdict(list)

    def add(self, name: str, t0: float, t1: float, extra: Any = None):
        rec = (threading.get_native_id(), threading.get_ident(), t0, t1,
               extra)
        with self._lock:
            self.data[name].append(rec)

    def within(self, name: str, t0: float, t1: float) -> List[tuple]:
        return [s for s in self.data.get(name, ()) if t0 <= s[2] <= t1]


def install(engine, spans: Spans) -> None:
    """Wrap the engine instance's dispatch and step methods in spans."""
    batch, run = engine.predict_multimodal_batch, engine._run

    def predict_multimodal_batch(requests):
        t0 = pc()
        try:
            return batch(requests)
        finally:
            spans.add('dispatch', t0, pc(), len(requests))

    def _run(step, *args):
        if step != '_trimodal_forward':
            return run(step, *args)
        first = args[0][0] if isinstance(args[0], tuple) else args[0]
        t0 = pc()
        try:
            return run(step, *args)
        finally:
            spans.add('step', t0, pc(), int(first.shape[0]))

    engine.predict_multimodal_batch = predict_multimodal_batch
    engine._run = _run


@dataclass
class Record:
    req: Any
    due: Optional[float] = None       # perf_counter time it was due
    t_send: Optional[float] = None
    t_done: Optional[float] = None
    answer: Any = None
    error: Optional[str] = None


def request_fn(engine, batcher, spans: Optional[Spans]) -> Callable:
    def call(req) -> Any:
        t0 = pc()
        payload = engine.predecode_multimodal(req.payload())
        if spans is not None:
            spans.add('decode', t0, pc())
        return batcher.multimodal.submit(payload)
    return call


def _do(call: Callable, rec: Record) -> None:
    rec.t_send = pc()
    try:
        rec.answer = call(rec.req)
    except Exception as e:  # counted as failed, named in the output
        rec.error = f'{type(e).__name__}: {e}'
    rec.t_done = pc()


class OpenLoop:
    def __init__(self, call: Callable, requests: List, t0: float,
                 workers: int):
        self.records = [Record(r, due=t0 + r.due) for r in requests]
        self.pool = concurrent.futures.ThreadPoolExecutor(
            workers, thread_name_prefix='bench-req')
        self.futures: List[concurrent.futures.Future] = []
        self.thread = threading.Thread(target=self._schedule, args=(call,),
                                       name='bench-sched', daemon=True)
        self.thread.start()

    def _schedule(self, call):
        for rec in self.records:
            wait = rec.due - pc()
            if wait > 0:
                time.sleep(wait)
            self.futures.append(self.pool.submit(_do, call, rec))

    def finish(self, deadline: float) -> None:
        self.thread.join(max(0.0, deadline - pc()))
        concurrent.futures.wait(self.futures,
                                timeout=max(0.0, deadline - pc()))
        self.pool.shutdown(wait=False, cancel_futures=True)


class ClosedLoop:
    def __init__(self, call: Callable, requests: List, clients: int,
                 t_end: float):
        self.records: List[Record] = []
        self._next = itertools.count()
        self._lock = threading.Lock()
        self.threads = [threading.Thread(target=self._client,
                                         args=(call, requests, t_end),
                                         name=f'bench-client-{c}',
                                         daemon=True)
                        for c in range(clients)]
        for t in self.threads:
            t.start()

    def _client(self, call, requests, t_end):
        while pc() < t_end:
            with self._lock:
                i = next(self._next)
            rec = Record(requests[i % len(requests)])
            self.records.append(rec)
            _do(call, rec)

    def finish(self, deadline: float) -> None:
        for t in self.threads:
            t.join(max(0.0, deadline - pc()))
