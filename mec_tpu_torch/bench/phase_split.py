#!/usr/bin/env python3
"""What the engine's own phase clock says about a benchmark window: one
run of a cell of benchmark/run.py in this process, with the StageTimer's
span log (utils/profiling.py) switched on where the window opens, read
against the harness's spans and the profiled sub-window. It reads the
benchmark from outside and changes none of its files.

    python3 -m mec_tpu_torch.bench.phase_split traced <cell> --seed N
        [--seconds 30] [--out DIR]
    python3 -m mec_tpu_torch.bench.phase_split untraced <cell> --seed N
        --log 0|1 [--seconds 30] [--out DIR]
    python3 -m mec_tpu_torch.bench.phase_split spancost [--older PATH]

traced: the run with --trace 1; the sub-window's CUDA API calls are
kept on the perf_counter clock (the offset trace.read derives
from its marker launches). One JSON line on standard error and
<out>/<cell>.<seed>.traced.json (--out, default <temp dir>/mec_phase_split)
hold:

* median wall and CPU ms of each of the engine's spans over the window;
* step_parts_over_harness: the median over the tri-modal dispatches of
  step.h2d + step.launch + step.fetch, over the median of the harness's
  own 'step' span around the same _run;
* step.launch_offcpu_share: 100 (1 - sum cpu_s / sum wall) over the
  window's step.launch spans (the launching thread not running: the
  interpreter lock or the OS);
* queue_wait_ms.all_in_window: the median of every
  batcher.multimodal.queue_wait_ms record ending in the window;
* dispatch_rows, dispatch_bucket: the medians of the window's
  trimodal.dispatch attributes (requests, and rows after padding);
* idle_split_s: the sub-window's idle time cut by interval overlap by
  the spans of ORDER in turn, what none covers as 'remainder'; the same
  for the gaps of each of breakdown's midpoint labels (idle_split_of.*);
* device.idle_launching_share: the share of the sub-window in which the
  card runs nothing and some thread is inside step.launch;
* launch calls: the share inside a program span on their own thread
  (the trace names a thread by the low 32 bits of its
  threading.get_ident(), on some threads only; a thread it names
  otherwise is placed by time where one logged thread's spans hold all
  its launch calls), the runtime calls and launches inside one
  tri-modal step.launch and by leg, and, for each thread of the trace,
  where its launch calls fall by time among the logged threads' spans.

A traced run dies in torch.profiler now and then (benchmark/run.py
reruns it; this one does not): run it again.

untraced: the run with --trace 0, the log on (--log 1) or off: the
log's cost end to end, beside the benchmark's own command.

spancost: the per-call cost of span() and record() with the log off and
on, 200,000 calls three times, beside an older profiling.py's StageTimer
(--older) with no log.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the spans that name an idle gap, first claim first
ORDER = ('step.launch.speech', 'step.launch.text', 'step.launch.image',
         'step.launch.fusion', 'step.launch', 'step.h2d', 'step.fetch',
         'trimodal.wire_encode', 'trimodal.decode_stage_ms',
         'trimodal.result_unpack', 'request.decode',
         'batcher.multimodal.queue_wait_ms', 'trimodal.dispatch',
         'batcher.multimodal.run')
MEDIANS = ('trimodal.dispatch', 'trimodal.decode_stage_ms',
           'trimodal.wire_encode', 'trimodal.wire_encode.speech',
           'trimodal.wire_encode.text', 'trimodal.wire_encode.image',
           'trimodal.dispatch_fetch', 'step.h2d', 'step.launch',
           'step.launch.speech', 'step.launch.text', 'step.launch.image',
           'step.launch.fusion', 'step.fetch', 'trimodal.result_unpack',
           'request.decode', 'request.decode.speech',
           'request.decode.image', 'batcher.multimodal.queue_wait_ms',
           'batcher.multimodal.run')
LEGS = ('speech', 'text', 'image', 'fusion')
# breakdown's midpoint labels (benchmark/run.py), first claim first
MIDPOINT = (('step', 'host:step_launch_or_fetch'),
            ('dispatch', 'host:dispatch_work'),
            ('decode', 'host:request_decode'))


def log(*a) -> None:
    print('phase_split', *a, file=sys.stderr, flush=True)


# ----------------------------------------------------------------------
# intervals: lists of (start, end)
# ----------------------------------------------------------------------

def union(iv):
    """Sorted, disjoint cover of the intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs, ys):
    """xs and ys, both sorted and disjoint."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys):
    """xs less ys, both sorted and disjoint."""
    out, j = [], 0
    for a, b in xs:
        cur = a
        while j < len(ys) and ys[j][1] <= cur:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            c, d = ys[k]
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def total(iv) -> float:
    return sum(b - a for a, b in iv)


def split(gaps, cover, order=ORDER):
    """The seconds of gaps (sorted, disjoint) that each name of order
    covers (cover: name -> sorted disjoint intervals), each name taking
    what the earlier ones left; 'remainder' what none covers."""
    left, out = list(gaps), {}
    for name in order:
        got = intersect(left, cover.get(name, []))
        out[name] = total(got)
        left = subtract(left, got)
    out['remainder'] = total(left)
    return out


def median(v):
    return statistics.median(v) if v else None


def thread_key(rec) -> int:
    """The id a torch.profiler trace gives the thread's runtime calls."""
    return rec.ident & 0xFFFFFFFF


# ----------------------------------------------------------------------
# the readings
# ----------------------------------------------------------------------

def midpoint_labels(gaps, harness):
    """Each gap under the label breakdown gives it by what the harness's
    spans (name -> [(tid, ident, t0, t1, n)]) cover at its middle."""
    out = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = next((lab for name, lab in MIDPOINT
                      if any(s[2] <= mid <= s[3]
                             for s in harness.get(name, ()))),
                     'host:no_dispatch_in_flight')
        out.setdefault(label, []).append((a, b))
    return out


def analyse(recs, window, harness, sub=None, calls=()):
    """recs: the span log; window (t0, t1); harness: the harness's spans
    by name; sub: the profiled sub-window (start, stop, gaps), or None;
    calls: its runtime calls (name, trace tid, t0, t1), perf clock."""
    t0, t1 = window
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    out = {'records': len(recs)}
    for name in MEDIANS:
        inside = [r for r in by.get(name, ()) if t0 <= r.t0 <= t1]
        out['median_ms.' + name] = median(
            [(r.t1 - r.t0) * 1e3 for r in inside])
        out['median_cpu_ms.' + name] = median(
            [r.cpu_s * 1e3 for r in inside if r.cpu_s is not None])
    qw = [(r.t1 - r.t0) * 1e3 for r in
          by.get('batcher.multimodal.queue_wait_ms', ()) if t0 <= r.t1 <= t1]
    out['queue_wait_ms.all_in_window'] = median(qw)
    dispatches = [r for r in by.get('trimodal.dispatch', ())
                  if t0 <= r.t0 <= t1]
    for attr in ('rows', 'bucket'):
        out['dispatch_' + attr] = median(
            [r.attrs[attr] for r in dispatches if attr in r.attrs])
    out['queue_wait_n'] = len(qw)
    launches = [r for r in by.get('step.launch', ()) if t0 <= r.t0 <= t1]
    wall = sum(r.t1 - r.t0 for r in launches)
    out['step.launch_offcpu_share'] = (
        100.0 * (1 - sum(r.cpu_s for r in launches) / wall)
        if wall else None)
    # h2d + launch + fetch of each tri-modal _run against the harness's
    # step span around it, on the same thread
    parts = {}
    for r in recs:
        if r.name in ('step.h2d', 'step.launch', 'step.fetch') \
                and r.attrs.get('step') == '_trimodal_forward':
            parts.setdefault(r.ident, []).append(r)
    sums, walls = [], []
    for _tid, ident, a, b, _n in harness.get('step', ()):
        if not t0 <= a <= t1:
            continue
        inner = [r for r in parts.get(ident, ()) if a <= r.t0 and r.t1 <= b]
        if len(inner) == 3:
            sums.append(sum(r.t1 - r.t0 for r in inner) * 1e3)
            walls.append((b - a) * 1e3)
    out['step_parts_ms'] = median(sums)
    out['harness_step_ms'] = median(walls)
    out['step_parts_over_harness'] = (median(sums) / median(walls)
                                      if sums else None)
    out['step_parts_matched'] = len(sums)
    if sub is None:
        return out
    w0, w1, gaps = sub
    gaps = union([(max(a, w0), min(b, w1)) for a, b in gaps
                  if min(b, w1) > max(a, w0)])
    out['sub_window_s'] = w1 - w0
    out['idle_s'] = total(gaps)
    cover = {name: union([(r.t0, r.t1) for r in by.get(name, ())
                          if r.t1 > w0 and r.t0 < w1]) for name in ORDER}
    out['idle_split_s'] = split(gaps, cover)
    for label, iv in midpoint_labels(gaps, harness).items():
        out['idle_split_of.' + label] = split(union(iv), cover)
    out['device.idle_launching_share'] = (
        100.0 * total(intersect(gaps, cover['step.launch'])) / (w1 - w0))
    out.update(calls_in_spans(recs, by, (w0, w1), calls))
    return out


def calls_in_spans(recs, by, sub, calls):
    """The sub-window's runtime calls against the log's spans. A trace
    thread whose id no logged thread has is placed by time: it is taken
    for the one logged thread whose spans hold all its launch calls,
    where there is just one."""
    w0, w1 = sub
    launchish = [c for c in calls if 'aunch' in c[0]]
    spans = {}
    for r in recs:
        if r.t1 > w0 and r.t0 < w1:
            spans.setdefault(thread_key(r), []).append((r.t0, r.t1))
    spans = {k: union(v) for k, v in spans.items()}

    def inside(iv, t):
        i = bisect.bisect_right(iv, (t, float('inf'))) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]
    placed, alias = {}, {}
    for tid in sorted({c[1] for c in launchish}, key=str):
        mine = [c for c in launchish if c[1] == tid]
        row = {k: n for k, iv in spans.items()
               if (n := sum(inside(iv, c[2]) for c in mine))}
        placed[str(tid)] = {'launch_calls': len(mine), 'inside_by_time':
                            {hex(k): n for k, n in row.items()}}
        whole = [k for k, n in row.items() if n == len(mine)]
        if tid not in spans and len(whole) == 1:
            alias[tid] = whole[0]
    matched = [c for c in launchish if c[1] in spans]
    n_in = sum(1 for c in matched if inside(spans[c[1]], c[2]))
    out = {'launch_calls': len(launchish),
           'trace_threads': len(placed),
           'trace_threads_matched': len({c[1] for c in matched}),
           'trace_threads_placed_by_time': len(alias),
           'launch_calls_on_matched_threads': len(matched),
           'launch_calls_inside_own_thread_span_share':
               n_in / len(matched) if matched else None,
           'launch_calls_placed_by_time': sum(c[1] in alias
                                              for c in launchish)}
    per_key = {}
    for c in sorted(calls, key=lambda c: c[2]):
        per_key.setdefault(alias.get(c[1], c[1]), []).append(c)
    starts = {k: [c[2] for c in v] for k, v in per_key.items()}

    def calls_in(r):
        k = thread_key(r)
        t = starts.get(k, [])
        return per_key.get(k, [])[bisect.bisect_left(t, r.t0):
                                  bisect.bisect_right(t, r.t1)]
    steps = [r for r in by.get('step.launch', ())
             if w0 <= r.t0 and r.t1 <= w1
             and r.attrs.get('step') == '_trimodal_forward']
    out['step.launch_calls'] = median([len(calls_in(r)) for r in steps])
    out['step.launch_launches'] = median(
        [sum('aunch' in c[0] for c in calls_in(r)) for r in steps])
    out['step.launch_in_sub'] = len(steps)
    for leg in LEGS:
        out['launches.' + leg] = median(
            [sum('aunch' in c[0] for c in calls_in(r))
             for r in by.get('step.launch.' + leg, ())
             if w0 <= r.t0 and r.t1 <= w1])
    out['trace_threads_by_time'] = placed
    return out


# ----------------------------------------------------------------------
# the runs
# ----------------------------------------------------------------------

def keep_calls(trace, calls):
    """Wrap trace.read so that it also keeps the sub-window's CUDA API
    calls in calls, on the perf_counter clock."""
    read = trace.read

    def reading(events, t_start, t_stop):
        r = read(events, t_start, t_stop)
        runtime = {}
        for e in events:
            if e.get('cat') in ('cuda_runtime', 'cuda_driver'):
                c = (e.get('args') or {}).get('correlation')
                if c is not None:
                    runtime[c] = e
        # trace.read's offset: the marker kernels' launches, split into
        # the start and end groups
        marks = sorted(runtime[e['args']['correlation']]['ts']
                       for e in events if e.get('cat') == 'kernel'
                       and trace.MARK in e.get('name', '')
                       and (e.get('args') or {}).get('correlation')
                       in runtime)
        span = (t_stop - t_start) * 1e6
        if marks[-1] - marks[0] > span / 2:
            cut = max(range(1, len(marks)),
                      key=lambda i: marks[i] - marks[i - 1])
            st, en = marks[:cut], marks[cut:]
        elif marks[0] - min(e['ts'] for e in runtime.values()) > span / 2:
            st, en = [], marks
        else:
            st, en = marks, []
        offs = ([m - t_start * 1e6 for m in st]
                + [m - t_stop * 1e6 for m in en])
        off = sum(offs) / len(offs)
        for e in events:
            if e.get('cat') in ('cuda_runtime', 'cuda_driver') \
                    and e.get('ph') == 'X':
                t = (e['ts'] - off) / 1e6
                if r.start <= t <= r.stop:
                    calls.append((e.get('name', ''), e.get('tid'), t,
                                  t + e.get('dur', 0) / 1e6))
        return r
    trace.read = reading


def run_cell(cell, seed, seconds, traced, log_on, out_dir,
             device='cuda') -> int:
    """One run of the cell through benchmark/run.py's main, in this
    process, with the span log on (log_on) from the window's start."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # the traced run stays in this process (run.py would start a child)
    os.environ['MEC_BENCH_TRACED_CHILD'] = '1'
    from benchmark import run
    from benchmark.harness import trace
    from mec_tpu_torch.utils.profiling import timer
    reset, seen, calls, result = timer.reset, {}, [], {}

    def reset_and_log():
        reset()
        if log_on:
            timer.start_log()
    timer.reset = reset_and_log

    class Context(run.Context):
        def __init__(self, **kw):
            super().__init__(**kw)
            seen['ctx'] = self
    run.Context = Context
    if traced:
        keep_calls(trace, calls)
        breakdown = run.breakdown

        def breakdown_and_split(reading, spans, ctx):
            result['phase_split'] = analyse(
                timer.log(), ctx.window, spans.data,
                (reading.start, reading.stop, reading.gaps), calls)
            return breakdown(reading, spans, ctx)
        run.breakdown = breakdown_and_split
    rc = run.main(['--workload', cell, '--seed', str(seed), '--seconds',
                   str(seconds), '--trace', str(int(traced))],
                  device=device)
    timer.stop_log()
    if 'phase_split' not in result and log_on and 'ctx' in seen:
        ctx = seen['ctx']
        result['phase_split'] = analyse(timer.log(), ctx.window,
                                        ctx.spans.data)
    result['log_records'] = len(timer.log())
    result['log_dropped'] = timer.log_dropped
    tag = f'{cell}.{seed}.' + ('traced' if traced else f'log{int(log_on)}')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, tag + '.json'), 'w') as f:
        json.dump(result, f, indent=1, default=str)
    if 'phase_split' in result:
        p = result['phase_split']
        log(tag, json.dumps({k: v for k, v in p.items()
                             if not isinstance(v, dict)}, default=str))
        log(tag, 'idle_split_s', json.dumps(p.get('idle_split_s')))
    return rc


def spancost(older=None, n=200_000, rounds=3) -> dict:
    """us a call of span() and record(), the log off and on, and an older
    profiling.py's StageTimer (no log) where given."""
    from mec_tpu_torch.utils.profiling import StageTimer
    kinds = [('log_off', StageTimer, False), ('log_on', StageTimer, True)]
    if older:
        import importlib.util
        spec = importlib.util.spec_from_file_location('older_profiling',
                                                      older)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        kinds.insert(0, ('older', mod.StageTimer, False))
    res = {}
    for _ in range(rounds):
        for name, cls, on in kinds:
            for call in ('span', 'record'):
                t = cls()
                if on:
                    t.start_log()
                a = time.perf_counter()
                if call == 'span':
                    for _ in range(n):
                        with t.span('x'):
                            pass
                else:
                    for _ in range(n):
                        t.record('y', 1.0)
                res.setdefault(f'{name}.{call}_us', []).append(
                    (time.perf_counter() - a) / n * 1e6)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('mode', choices=('traced', 'untraced', 'spancost'))
    ap.add_argument('cell', nargs='?')
    ap.add_argument('--seed', type=int)
    ap.add_argument('--seconds', type=float, default=30.0)
    ap.add_argument('--log', type=int, choices=(0, 1), default=1)
    ap.add_argument('--older', help='an older profiling.py (spancost)')
    ap.add_argument('--out', default=os.path.join(tempfile.gettempdir(),
                                                  'mec_phase_split'))
    args = ap.parse_args(argv)
    if args.mode == 'spancost':
        log('spancost', json.dumps(spancost(args.older)))
        return 0
    if args.cell is None or args.seed is None:
        ap.error(f'{args.mode} needs a cell and --seed')
    traced = args.mode == 'traced'
    return run_cell(args.cell, args.seed, args.seconds, traced,
                    traced or bool(args.log), args.out)


if __name__ == '__main__':
    sys.exit(main())
