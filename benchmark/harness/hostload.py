"""What the host did during the window, for the run's log (stderr only;
no metric reads it): this process's CPU time, the time the interpreter
spent in garbage collection by generation, and the window cut into
slices of equal length, each with its answers and the median latency of
the requests sent in it. A run that reads slower than its neighbours
shows here whether one stall or the whole window did it.
"""

from __future__ import annotations

import gc
import os
import statistics
import time
from typing import List


def cpu_seconds() -> float:
    """This process's CPU time so far, user and system, all threads."""
    t = os.times()
    return t.user + t.system


def slices(records: List, t0: float, t1: float, n: int = 6) -> str:
    """Answers completed and the median latency (ms) of the requests sent
    in each of n equal slices of the window."""
    edges = [t0 + (t1 - t0) * i / n for i in range(n + 1)]
    parts = []
    for lo, hi in zip(edges, edges[1:]):
        done = sum(1 for r in records if r.t_done is not None
                   and lo <= r.t_done < hi and r.answer is not None)
        lat = [(r.t_done - r.t_send) * 1e3 for r in records
               if r.t_send is not None and lo <= r.t_send < hi
               and r.t_done is not None]
        med = statistics.median(lat) if lat else float('nan')
        parts.append(f'{done}/{med:.2f}')
    return (f'window slices of {(t1 - t0) / n:.1f} s (answered/median ms '
            f'of those sent): ' + ' '.join(parts))


class GcClock:
    """Counts the interpreter's garbage collections and the seconds they
    took, by generation, from start() to stop(): a collection holds every
    thread of the interpreter."""

    def __init__(self):
        self.n = [0, 0, 0]
        self.s = [0.0, 0.0, 0.0]
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == 'start':
            self._t = time.perf_counter()
        else:
            g = info.get('generation', 2)
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self._t

    def start(self):
        gc.callbacks.append(self._cb)

    def stop(self) -> str:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)
        return ('garbage collections in the window by generation: ' +
                ', '.join(f'{n} in {s * 1e3:.1f} ms'
                          for n, s in zip(self.n, self.s)))
