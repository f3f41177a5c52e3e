"""Percentile and rate arithmetic over all requests, and the
metric readers on hand-made spans, counters and trace readings."""

import math
from types import SimpleNamespace

import pytest

from benchmark.harness import drive, stats
from benchmark.harness.cells import Cell
from benchmark.harness.trace import Launch, Reading, read
from benchmark.run import Context

CELL = Cell('resnet50_bert_attn.one_client')


def reader(name, kind='layer_metrics'):
    return CELL.reader(name, kind)


def test_percentile_nearest_rank_over_all():
    v = list(range(1, 101))
    assert stats.percentile(v, 50) == 50
    assert stats.percentile(v, 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    # an unanswered request is infinitely late and counts
    assert math.isinf(stats.percentile(v[:90] + [math.inf] * 10, 95))
    assert stats.percentile(v[:95] + [math.inf] * 5, 95) == 95


def test_rate_counts_inside_the_window():
    assert stats.rate([0.5, 1.0, 2.0, 3.0, 3.5], 1.0, 3.0) == 1.5


def _spans(**named):
    s = drive.Spans()
    for name, items in named.items():
        s.data[name] = list(items)
    return s


def test_end_to_end_readers():
    rec = [SimpleNamespace(t_done=t, answer={}) for t in (1.5, 2.5, 9.0)]
    ctx = Context(setup_s=12.5, records=rec, window=(1.0, 3.0),
                  served=lambda a: True, latencies_ms=[5.0, 7.0, 30.0])
    assert reader('setup_s', 'end_to_end').read(ctx) == 12.5
    assert reader('preds_per_s', 'end_to_end').read(ctx) == 1.0
    assert reader('latency_p50_ms', 'end_to_end').read(ctx) == 7.0
    assert reader('latency_p95_ms.one_client').read(ctx) == 30.0


def test_host_ms_subtracts_the_nested_step():
    spans = _spans(dispatch=[(1, 1, 0.0, 0.050, 32), (2, 2, 0.01, 0.07, 32),
                             (1, 1, 5.0, 5.1, 32)],
                   step=[(1, 1, 0.010, 0.040, 32), (2, 2, 0.03, 0.05, 32)])
    ctx = Context(spans=spans, window=(0.0, 1.0))
    # 50 - 30 and 60 - 20 ms; the third dispatch is outside the window
    assert reader('engine.host_ms.saturated').read(ctx) == \
        pytest.approx(30.0)
    assert reader('step.ms.one_client').read(ctx) == pytest.approx(25.0)


def test_batch_size_and_queue_wait():
    ctx = Context(stats={'batches': 10, 'items': 290},
                  timer={'batcher.multimodal.queue_wait_ms': {'p50_ms': 4.5}})
    assert reader('batcher.batch_size.saturated').read(ctx) == 29.0
    assert reader('batcher.queue_wait_ms.one_client').read(ctx) == 4.5
    empty = Context(stats={'batches': 0, 'items': 0}, timer={})
    assert reader('batcher.batch_size.saturated').read(empty) is None
    assert reader('batcher.queue_wait_ms.one_client').read(empty) is None


def test_mfu_is_model_flops_over_the_peak():
    done = [SimpleNamespace(req=SimpleNamespace(index=i, text='x')) for i in
            range(100)]
    flops = SimpleNamespace(request_flops=lambda tokens: 1e10 * tokens)
    ctx = Context(done=done, window=(0.0, 2.0), flops=flops,
                  peaks={'bf16_tc': 1e14})
    ctx.tokens = lambda r: 2
    # 100 x 2e10 over 2 s x 1e14 = 1%
    assert reader('mfu.saturated').read(ctx) == pytest.approx(1.0)


def test_roofline_share_and_idle_share():
    # two steps start inside the sub-window [0, 2], one after it
    spans = _spans(step=[(7, 70, 0.0, 1.0, 32), (8, 80, 0.5, 2.0, 8),
                         (7, 70, 2.5, 3.0, 32)])
    launches = [Launch('void mfcc_mean_kernel<4>(float const*)', 20.0),
                Launch('conv3x3_kernel(Conv64Args)', 100.0),
                Launch('conv3x3_kernel(Conv64Args)', 100.0),
                Launch('elementwise_kernel', 50.0)]
    t = Reading(window_s=2.0, busy_s=0.5, ops=[], gaps=[],
                launches=launches, start=0.0, stop=2.0)
    ctx = Context(spans=spans, trace=t, bounds=CELL.bounds())
    b = CELL.bounds()
    # every launch of a hand-written kernel counts; each kernel that ran
    # is bounded at each step's bucket; kernels that did not run are not
    want = sum(b[k].bound_ms(n) for k in ('mfcc_mean', 'layer1_int8')
               for n in (32, 8)) / (0.020 + 0.200)
    assert reader('kernels_roofline.saturated').read(ctx) == \
        pytest.approx(100 * want)
    assert reader('device.idle_share.saturated').read(ctx) == \
        pytest.approx(75.0)
    assert reader('kernels_roofline.saturated').read(
        Context(trace=None)) is None
    no_steps = Context(spans=_spans(step=[]), trace=t, bounds=CELL.bounds())
    assert reader('kernels_roofline.saturated').read(no_steps) is None


def test_trace_reading_from_events():
    ev = [{'ph': 'X', 'name': 'cudaLaunchKernel', 'ts': 1000.0, 'dur': 2,
           'cat': 'cuda_runtime', 'args': {'correlation': 1}},
          {'ph': 'X', 'name': 'spin_kernel(long)', 'ts': 1010.0, 'dur': 1,
           'cat': 'kernel', 'args': {'correlation': 1}},
          {'ph': 'X', 'name': 'cudaLaunchKernel', 'ts': 11000.0, 'dur': 2,
           'cat': 'cuda_runtime', 'args': {'correlation': 2}},
          {'ph': 'X', 'name': 'spin_kernel(long)', 'ts': 11010.0, 'dur': 1,
           'cat': 'kernel', 'args': {'correlation': 2}},
          {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
           'ts': 1500.0, 'dur': 5, 'tid': 42, 'args': {'correlation': 9}},
          {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 2000.0,
           'dur': 1000, 'args': {'correlation': 9}},
          {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 2500.0,
           'dur': 1000, 'args': {}},
          {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'm', 'ts': 10500.0,
           'dur': 1000, 'args': {}}]
    r = read(ev, 100.0, 100.01)
    assert r.window_s == pytest.approx(0.010)
    assert len(r.launches) == 2         # the marker kernels are no launch
    # the marks' launches at 1000 and 11000 us are perf 100.0 and 100.01:
    # [1010, 1011], [2000, 3500] and [10500, 11000] inside [1000, 11000]
    assert r.busy_s == pytest.approx(0.002001)
    assert r.ops[0] == ('k', pytest.approx(0.002))
    assert [la.dur for la in r.launches] == [1000, 1000]
    assert (r.start, r.stop) == (pytest.approx(100.0, abs=1e-9),
                                 pytest.approx(100.01, abs=1e-9))
    assert [round(b - a, 6) for a, b in r.gaps] == [1e-05, 0.000989, 0.007]


def test_trace_reading_keeps_one_group_of_marks():
    ev = [{'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
           'ts': 500.0, 'dur': 5, 'tid': 1, 'args': {'correlation': 3}},
          {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': 600.0, 'dur': 100,
           'args': {'correlation': 3}},
          {'ph': 'X', 'name': 'cudaLaunchKernel', 'ts': 11000.0, 'dur': 2,
           'cat': 'cuda_runtime', 'args': {'correlation': 2}},
          {'ph': 'X', 'name': 'spin_kernel(long)', 'ts': 11010.0, 'dur': 1,
           'cat': 'kernel', 'args': {'correlation': 2}}]
    # the start's marks were lost; the launches before the end's tell
    r = read(ev, 100.0, 100.0105)
    assert r.window_s == pytest.approx(0.0105)
    assert len(r.launches) == 1
    assert r.start == pytest.approx(100.0, abs=1e-9)



def test_a_traced_run_killed_by_a_signal_runs_once_more(tmp_path, capfd):
    from benchmark import run
    import sys
    once = tmp_path / 'once.py'
    once.write_text(
        'import os, signal\n'
        'if not os.environ.get("MEC_BENCH_TRACED_RETRY"):\n'
        '    os.kill(os.getpid(), signal.SIGABRT)\n'
        'print("result after", os.environ["MEC_BENCH_TRACED_RETRY"])\n')
    assert run.traced_in_child([sys.executable, str(once)], {}) == 0
    out, err = capfd.readouterr()
    assert out.strip() == 'result after 6'
    assert 'died of signal 6' in err
    # a second death, or an exit code of its own, is passed on
    always = tmp_path / 'always.py'
    always.write_text('import os, signal\n'
                      'os.kill(os.getpid(), signal.SIGSEGV)\n')
    assert run.traced_in_child([sys.executable, str(always)], {}) == 1
    fails = tmp_path / 'fails.py'
    fails.write_text('raise SystemExit(3)\n')
    assert run.traced_in_child([sys.executable, str(fails)], {}) == 3
