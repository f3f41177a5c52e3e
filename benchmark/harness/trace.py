"""The profiled sub-window of a traced run, and what is read from it.

torch.profiler runs over the last few seconds of the window, with its
CUDA activity alone (kernels, copies, sets and the runtime calls that
launched them; no host operators, which would be recorded in every
request thread), and stops after the window. Three marker kernels
launched from the controlling thread at each end (torch.cuda._sleep's
spin kernel; the profiler may lose a launch at a window's edge) give the
offset between the trace's clock and time.perf_counter, on which the
harness's spans and the sub-window's ends are taken. From the exported
trace:

  busy      the union of the device's kernels, copies and sets inside
            the sub-window (seconds);
  ops       device time by operation name;
  gaps      the idle intervals of the device, each named by what the
            host was doing at its middle (the harness's spans);
  launches  each kernel that starts inside the sub-window, by name and
            device time;
  start, stop  the sub-window's ends on the perf_counter clock.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

MARK = 'spin_kernel'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def warm_profiler() -> None:
    """One short profile in set-up, so that the tracer's first start does
    not fall into the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(256, device='cuda')
    with profile(activities=[ProfilerActivity.CUDA]):
        (x * 2).sum().item()
    torch.cuda.synchronize()


@dataclass
class Launch:
    name: str
    dur: float           # device microseconds


@dataclass
class Reading:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float]]          # (name, device seconds), by time
    gaps: List[Tuple[float, float]]       # idle (start, end), perf_counter
    launches: List[Launch] = field(default_factory=list)
    events: int = 0
    start: float = 0.0                    # perf_counter seconds
    stop: float = 0.0


class SubWindow:
    def __init__(self, workdir: str):
        self.workdir = workdir
        self.prof = None
        self.t = []

    def mark(self) -> None:
        """Three marker kernels launched from the calling thread: the
        first group opens the sub-window, the second closes it."""
        import torch
        a = time.perf_counter()
        for _ in range(3):
            torch.cuda._sleep(1)
        self.t.append((a + time.perf_counter()) / 2)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(0.05)
        self.mark()

    def stop(self) -> Reading:
        """Stop the profiler (after the second mark) and read the
        sub-window between the two marks."""
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        path = os.path.join(self.workdir, 'subwindow_trace.json')
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
        os.remove(path)
        self.prof = None
        return read(events, self.t[0], self.t[1])


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(events: List[Dict], t_start: float, t_stop: float) -> Reading:
    """The sub-window between the two marker kernels' launches."""
    runtime = {}
    for e in events:
        if e.get('cat') in ('cuda_runtime', 'cuda_driver'):
            c = (e.get('args') or {}).get('correlation')
            if c is not None:
                runtime[c] = e
    marks = [runtime[e['args']['correlation']]['ts'] for e in events
             if e.get('cat') == 'kernel' and MARK in e.get('name', '')
             and (e.get('args') or {}).get('correlation') in runtime]
    if not marks:
        raise RuntimeError('the trace kept none of its six marker launches')
    # the two groups lie the sub-window apart; where one was lost, the
    # launches before the other tell which it was
    marks.sort()
    span = (t_stop - t_start) * 1e6
    if marks[-1] - marks[0] > span / 2:
        cut = max(range(1, len(marks)), key=lambda i: marks[i] - marks[i - 1])
        start, end = marks[:cut], marks[cut:]
    elif marks[0] - min(e['ts'] for e in runtime.values()) > span / 2:
        start, end = [], marks
    else:
        start, end = marks, []
    offs = ([m - t_start * 1e6 for m in start]
            + [m - t_stop * 1e6 for m in end])
    off = sum(offs) / len(offs)          # trace us = perf us + off
    w0, w1 = t_start * 1e6 + off, t_stop * 1e6 + off

    def perf(ts):
        return (ts - off) / 1e6
    dev = [e for e in events if e.get('cat') in DEVICE_CATS
           and e.get('ph') == 'X']
    inside, ops, launches = [], {}, []
    for e in dev:
        a, b = max(e['ts'], w0), min(e['ts'] + e.get('dur', 0), w1)
        if b <= a:
            continue
        inside.append((a, b))
        ops[e['name']] = ops.get(e['name'], 0.0) + (b - a) / 1e6
        if e['cat'] == 'kernel' and e['ts'] >= w0 and MARK not in e['name']:
            launches.append(Launch(e['name'], e.get('dur', 0)))
    busy = _union(inside)
    idle, prev = [], w0
    for a, b in busy:
        if a > prev:
            idle.append((perf(prev), perf(a)))
        prev = b
    if prev < w1:
        idle.append((perf(prev), perf(w1)))
    return Reading(window_s=(w1 - w0) / 1e6,
                   busy_s=sum(b - a for a, b in busy) / 1e6,
                   ops=sorted(ops.items(), key=lambda kv: -kv[1]),
                   gaps=idle, launches=launches, events=len(events),
                   start=perf(w0), stop=perf(w1))
