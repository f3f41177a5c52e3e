"""mec_tpu_torch/bench/phase_split.py, the span log's reader against a
benchmark window: its interval arithmetic, the idle split by overlap and
its remainder, the midpoint labels it sets beside it, the per-dispatch
readings on a hand-built log, the runtime calls matched to their
thread's spans, and one untraced tiny benchmark run on the CPU with the
log on.
"""

import json
import os
import subprocess
import sys

import pytest

from mec_tpu_torch.bench import phase_split as ps
from mec_tpu_torch.utils.profiling import SpanRecord

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 0x7F00_1234_5678          # a thread's get_ident(); the trace: low 32


def rec(name, t0, t1, cpu=None, ident=T, parent=None, step=None, i=0):
    attrs = {'step': step} if step else {}
    return SpanRecord(name, t0, t1, cpu, ident, parent, attrs, i)


def test_interval_arithmetic():
    assert ps.union([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [(0, 2), (3, 5)]
    xs, ys = [(0, 2), (3, 5)], [(1, 4), (4.5, 6)]
    assert ps.intersect(xs, ys) == [(1, 2), (3, 4), (4.5, 5)]
    assert ps.subtract(xs, ys) == [(0, 1), (4, 4.5)]
    assert ps.subtract(xs, []) == xs and ps.intersect(xs, []) == []
    assert ps.total(xs) == 4


def test_split_claims_in_order_and_leaves_a_remainder():
    gaps = [(0.0, 10.0), (20.0, 30.0)]
    cover = {'step.launch.text': [(1.0, 4.0)],
             'step.launch': [(0.0, 5.0)],          # less what text took
             'request.decode': [(4.0, 6.0), (25.0, 40.0)]}
    got = ps.split(gaps, cover)
    assert got['step.launch.text'] == 3.0
    assert got['step.launch'] == 2.0
    assert got['request.decode'] == 1.0 + 5.0
    assert got['step.h2d'] == 0.0
    assert got['remainder'] == pytest.approx(20.0 - 11.0)
    assert sum(got.values()) == pytest.approx(ps.total(gaps))


def test_midpoint_labels_file_a_gap_by_its_middle():
    harness = {'step': [(1, T, 0.0, 4.0, 1)],
               'decode': [(2, T, 6.0, 9.0, 1)]}
    got = ps.midpoint_labels([(1.0, 3.0), (3.5, 9.5), (10.0, 12.0)],
                             harness)
    # (3.5, 9.5) overlaps the step but its middle is in the decode
    assert got == {'host:step_launch_or_fetch': [(1.0, 3.0)],
                   'host:request_decode': [(3.5, 9.5)],
                   'host:no_dispatch_in_flight': [(10.0, 12.0)]}


def _dispatch(t, ident=T, i=0):
    """One tri-modal _run at t: h2d 1 ms, launch 40 ms (CPU 30), fetch
    2 ms, the legs inside the launch; the harness's step span around it."""
    step = '_trimodal_forward'
    recs = [rec('step.h2d', t, t + .001, .001, ident, step=step, i=i),
            rec('step.launch', t + .001, t + .041, .030, ident, step=step,
                i=i + 1),
            rec('step.launch.text', t + .001, t + .031, .025, ident, i + 1,
                i=i + 2),
            rec('step.launch.image', t + .031, t + .041, .005, ident, i + 1,
                i=i + 3),
            rec('step.fetch', t + .041, t + .043, .002, ident, step=step,
                i=i + 4),
            rec('batcher.multimodal.queue_wait_ms', t - .004, t, i=i + 5)]
    return recs, (0, ident, t, t + .044, 1)


def test_analyse_reads_the_dispatches():
    recs, steps = [], []
    for k in range(3):
        r, s = _dispatch(1.0 + 0.1 * k, i=10 * k)
        recs += r
        steps.append(s)
    out = ps.analyse(recs, (0.9, 2.0), {'step': steps})
    assert out['median_ms.step.launch'] == pytest.approx(40.0)
    assert out['median_cpu_ms.step.launch'] == pytest.approx(30.0)
    assert out['step.launch_offcpu_share'] == pytest.approx(25.0)
    assert out['queue_wait_ms.all_in_window'] == pytest.approx(4.0)
    assert out['queue_wait_n'] == 3
    assert out['step_parts_matched'] == 3
    assert out['step_parts_over_harness'] == pytest.approx(43 / 44)
    # a dispatch of another thread is not the harness span's
    other, _ = _dispatch(1.0, ident=T + 1, i=100)
    out = ps.analyse(recs + other, (0.9, 2.0), {'step': steps})
    assert out['step_parts_matched'] == 3


def test_analyse_splits_the_sub_window_and_matches_calls():
    recs, steps = _dispatch(1.0)
    tid = T & 0xFFFFFFFF
    calls = ([('cudaLaunchKernel', tid, 1.0025 + k * 1e-3,
               1.0026 + k * 1e-3) for k in range(35)]   # inside the launch
             + [('cudaLaunchKernel', tid, 1.05, 1.0501),   # outside
                ('cudaMemcpyAsync', tid, 1.0415, 1.0418),
                # a thread the trace names otherwise, inside T's spans
                ('cudaLaunchKernel', 77, 1.005, 1.0051),
                ('cudaLaunchKernel', 77, 1.006, 1.0061),
                # and one no span holds
                ('cudaLaunchKernel', 99, 1.07, 1.0701)])
    gaps = [(1.0, 1.02), (1.04, 1.06)]
    out = ps.analyse(recs, (0.9, 2.0), {'step': [steps]},
                     (1.0, 1.1, gaps), calls)
    assert out['sub_window_s'] == pytest.approx(0.1)
    assert out['idle_s'] == pytest.approx(0.04)
    split = out['idle_split_s']
    assert split['step.launch.text'] == pytest.approx(0.019)
    assert split['step.launch.image'] == pytest.approx(0.001)
    assert split['step.h2d'] == pytest.approx(0.001)
    assert split['step.fetch'] == pytest.approx(0.002)
    assert split['remainder'] == pytest.approx(0.017)
    # idle while the launch span is open: 0.019 + 0.001
    assert out['device.idle_launching_share'] == pytest.approx(20.0)
    assert out['launch_calls'] == 39
    assert out['launch_calls_on_matched_threads'] == 36
    assert out['launch_calls_inside_own_thread_span_share'] == \
        pytest.approx(35 / 36)
    assert out['trace_threads'] == 3 and out['trace_threads_matched'] == 1
    assert out['trace_threads_placed_by_time'] == 1
    assert out['launch_calls_placed_by_time'] == 2
    # thread 77's calls count in T's launch
    assert out['step.launch_calls'] == 37
    assert out['launches.text'] == 31 and out['launches.image'] == 6
    assert out['idle_split_of.host:step_launch_or_fetch']['remainder'] \
        == pytest.approx(0.0)


def test_spancost_times_both_calls():
    res = ps.spancost(n=200, rounds=1)
    assert set(res) == {'log_off.span_us', 'log_off.record_us',
                        'log_on.span_us', 'log_on.record_us'}
    assert all(len(v) == 1 and v[0] > 0 for v in res.values())


def test_untraced_tiny_run_with_the_log_on(tmp_path):
    """One untraced run of a tiny benchmark cell on the CPU through
    run_cell with the log on: the window's spans are read, the run's
    result line is the benchmark's own."""
    sys.path.insert(0, REPO)
    try:
        from benchmark.tests import tiny
    finally:
        sys.path.remove(REPO)
    root = str(tmp_path / 'root')
    tiny.make_root(root)
    out = str(tmp_path / 'out')
    code = ('import sys; sys.path[:0] = [%r, %r]\n'
            'from mec_tpu_torch.bench import phase_split\n'
            'sys.exit(phase_split.run_cell(%r, 2**31 + 5, 1, False, True, '
            '%r, device="cpu"))\n'
            % (root, REPO, 'tiny_resnet50_bert_attn.one_client', out))
    env = dict(os.environ, OMP_NUM_THREADS='2', MKL_NUM_THREADS='2')
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=root)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])['correct']
    with open(os.path.join(
            out, 'tiny_resnet50_bert_attn.one_client.2147483653.log1.json')
            ) as f:
        got = json.load(f)
    split = got['phase_split']
    assert got['log_records'] > 0 and got['log_dropped'] == 0
    for name in ('step.launch', 'trimodal.wire_encode', 'request.decode',
                 'batcher.multimodal.queue_wait_ms'):
        assert split['median_ms.' + name] > 0, name
    assert 0 <= split['step.launch_offcpu_share'] <= 100
    assert split['queue_wait_n'] > 0
    assert split['dispatch_rows'] >= 1 and split['dispatch_bucket'] >= 1
