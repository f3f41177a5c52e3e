"""The port's phase clock: the StageTimer's span log and totals
(mec_tpu_torch/utils/profiling.py) and the engine's spans
(mec_tpu_torch/serving/engine.py) on tiny CPU engines, attention and
random-forest fusion.

Contracts: the log is off until start_log() and summary() reads the same
with it on or off; a logged span carries its perf_counter interval, the
thread's CPU time, the thread's id and the innermost span open on its
thread; a record() covers [now - ms, now]; totals() counts every
call where summary() keeps the last `capacity`. A tri-modal dispatch
records every span of the engine's table, each child inside its parent
on the parent's thread, its direct children covering at least 95% of it;
the fused batch-1 path records the same spans and reads _last_b1_phases
off them, and a request it degrades leaves them empty. On the CPU warmup
captures no CUDA graph and every step runs eagerly, with its
step.launch.<leg> spans and no step.replay; a graph's key tells apart
what its replay could not serve, and new weights or scales drop every
replica's graphs.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import wav
from mec_tpu_torch.ops.quant import extract_static_scales
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.graphs import StepGraphs, signature
from mec_tpu_torch.serving.synthetic_artifacts import \
    write_synthetic_artifacts
from mec_tpu_torch.utils import profiling
from mec_tpu_torch.utils.profiling import StageTimer, timer

TEXTS = ['i am so happy today', 'this is terrible and sad',
         'wow what a surprise']
B1_KEYS = {'wav_load', 'tokenize', 'image_load', 'wire_encode',
           'dispatch_fetch', 'result_unpack'}
DISPATCH_CHILDREN = {'trimodal.decode_stage_ms', 'trimodal.wire_encode',
                     'trimodal.dispatch_fetch', 'trimodal.result_unpack'}
PARENT_OF = {
    'trimodal.wire_encode.speech': 'trimodal.wire_encode',
    'trimodal.wire_encode.text': 'trimodal.wire_encode',
    'trimodal.wire_encode.image': 'trimodal.wire_encode',
    'step.h2d': 'trimodal.dispatch_fetch',
    'step.launch': 'trimodal.dispatch_fetch',
    'step.fetch': 'trimodal.dispatch_fetch',
    'step.launch.speech': 'step.launch',
    'step.launch.text': 'step.launch',
    'step.launch.image': 'step.launch',
    'step.launch.fusion': 'step.launch',
    'request.decode.speech': 'request.decode',
    'request.decode.image': 'request.decode',
}


# ----------------------------------------------------------------------
# the StageTimer
# ----------------------------------------------------------------------

def test_log_is_off_by_default_and_leaves_summary_alone():
    quiet, logged = StageTimer(capacity=8), StageTimer(capacity=8)
    assert quiet.log() == []
    logged.start_log()
    for ms in (3.0, 1.0, 7.0, 2.0, 9.0, 4.0, 5.0, 8.0, 6.0, 0.5):
        quiet.record('s', ms)
        logged.record('s', ms)
    assert quiet.summary() == logged.summary()
    with quiet.span('t'):
        pass
    assert quiet.log() == [] and len(logged.log()) == 10
    assert quiet.summary()['t']['count'] == 1


def test_nested_spans_name_parent_thread_and_cpu_time():
    t = StageTimer()
    t.start_log()
    tids = {}

    def work(tag):
        tids[tag] = threading.get_ident()
        with t.span('outer', tag=tag) as outer:
            outer.attrs['late'] = 1
            with t.span('inner'):
                end = time.thread_time() + 0.02
                while time.thread_time() < end:     # CPU-bound
                    pass
            time.sleep(0.2)                         # off the CPU

    th = threading.Thread(target=work, args=('b',))
    th.start()
    th.join(10)
    assert not th.is_alive()
    work('a')
    recs = {(r.name, r.ident): r for r in t.log()}
    assert len(recs) == 4
    for tag in ('a', 'b'):
        outer = recs[('outer', tids[tag])]
        inner = recs[('inner', tids[tag])]
        assert outer.parent is None and inner.parent == outer.id
        assert outer.attrs == {'tag': tag, 'late': 1}
        assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
        assert inner.cpu_s >= 0.015
        # the sleep is wall time the thread spent off the CPU (a margin
        # that holds where thread_time() ticks in 10 ms)
        assert outer.cpu_s < (outer.t1 - outer.t0) - 0.1
    assert tids['a'] != tids['b']


def test_record_covers_the_ms_before_now():
    t = StageTimer()
    t.start_log()
    with t.span('outer'):
        before = time.perf_counter()
        t.record('wait', 250.0)
        after = time.perf_counter()
    wait, outer = t.log()
    assert wait.name == 'wait' and wait.cpu_s is None
    assert before <= wait.t1 <= after
    assert wait.t1 - wait.t0 == pytest.approx(0.25)
    assert wait.parent == outer.id
    assert wait.ident == threading.get_ident()


def test_totals_count_past_the_reservoir():
    t = StageTimer()
    for i in range(5000):
        t.record('q', 1.0 + (i % 2))
    assert t.summary()['q']['count'] == 4096
    assert t.totals() == {'q': {'count': 5000, 'sum_ms': 7500.0}}
    t.reset()
    assert t.totals() == {} and t.summary() == {}


def test_log_capacity_stop_and_reset(monkeypatch):
    monkeypatch.setattr(profiling, 'LOG_CAPACITY', 3)
    t = StageTimer()
    t.start_log()
    for _ in range(5):
        t.record('r', 1.0)
    assert len(t.log()) == 3 and t.log_dropped == 2
    t.reset()
    assert t.log() == [] and t.log_dropped == 0
    t.record('before', 1.0)
    with t.span('open'):
        t.stop_log()
    t.record('after', 1.0)
    # a span still open at the stop ends after it: not logged
    assert [r.name for r in t.log()] == ['before']
    assert t.totals()['after']['count'] == t.totals()['open']['count'] == 1


def test_log_under_many_threads():
    """32 threads of nested spans, switching every 10 us: no count is
    lost, and every logged child sits inside its parent on its thread."""
    t = StageTimer(capacity=64)
    t.start_log()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            for _ in range(200):
                with t.span('a'):
                    with t.span('b'):
                        t.record('c', 0.0)
        threads = [threading.Thread(target=work) for _ in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert {k: v['count'] for k, v in t.totals().items()} == {
        'a': 6400, 'b': 6400, 'c': 6400}
    log = t.log()
    assert len(log) == 3 * 6400
    by_id = {r.id: r for r in log}
    assert len(by_id) == len(log)
    want = {'a': None, 'b': 'a', 'c': 'b'}
    for r in log:
        if r.parent is None:
            assert want[r.name] is None
            continue
        p = by_id[r.parent]
        assert p.name == want[r.name] and p.ident == r.ident
        assert p.t0 <= r.t0 and r.t1 <= p.t1


# ----------------------------------------------------------------------
# the engine's spans
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def engines(tmp_path_factory):
    """Tiny fp32 CPU engines over the port's synthetic artifacts, one
    a fusion mode, and three uploads."""
    d = str(tmp_path_factory.mktemp('models'))
    write_synthetic_artifacts(d, tiny=True, image_size=32)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    old = Config.FUSION_MODE
    out = {}
    try:
        for mode in ('attention', 'rf'):
            Config.FUSION_MODE = mode
            out[mode] = EmotionEngine.from_models_dir(
                d, compute_dtype='float32', device='cpu')
            assert out[mode]._fusion_kind == mode and out[mode]._all_live
    finally:
        Config.FUSION_MODE = old
    reqs = []
    rng = np.random.RandomState(0)
    t = np.arange(66150) / 22050.0
    for i, text in enumerate(TEXTS):
        a, p = os.path.join(d, f'a{i}.wav'), os.path.join(d, f'i{i}.png')
        wav.write_wav(a, (0.1 * np.sin(2 * np.pi * (200 + 90 * i) * t)
                          ).astype(np.float32), 22050)
        Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8)).save(p)
        reqs.append({'audio_path': a, 'text': text, 'image_path': p})
    yield out, reqs
    torch.set_num_threads(threads)


@pytest.fixture()
def logged():
    timer.reset()
    timer.start_log()
    try:
        yield timer
    finally:
        timer.stop_log()
        timer.reset()


def _root(rec, by_id):
    while rec.parent is not None:
        rec = by_id[rec.parent]
    return rec


def _check_tree(log):
    """Every child inside its parent, on its thread, under the parent
    PARENT_OF names; returns the records by id."""
    by_id = {r.id: r for r in log}
    for r in log:
        if r.parent is None:
            continue
        p = by_id[r.parent]
        assert p.ident == r.ident, r
        assert p.t0 <= r.t0 and r.t1 <= p.t1, (r, p)
        if r.name in PARENT_OF:
            assert p.name == PARENT_OF[r.name], (r, p)
        if r.name in DISPATCH_CHILDREN:
            assert p.name == 'trimodal.dispatch', (r, p)
    return by_id


@pytest.mark.parametrize('mode', ['attention', 'rf'])
def test_batch_dispatch_records_every_span(engines, logged, mode):
    engs, reqs = engines
    eng = engs[mode]
    pre = [eng.predecode_multimodal(r) for r in reqs]
    out = eng.predict_multimodal_batch(pre)
    assert all(o['fusion']['emotion'] in Config.EMOTIONS for o in out)
    log = logged.log()
    by_id = _check_tree(log)
    names = {r.name for r in log}
    assert names >= set(PARENT_OF) | DISPATCH_CHILDREN | {
        'trimodal.dispatch', 'request.decode'}
    (dispatch,) = [r for r in log if r.name == 'trimodal.dispatch']
    assert dispatch.attrs == {'rows': 3, 'bucket': 8}
    inside = [r for r in log if r.name != 'request.decode'
              and not r.name.startswith('request.decode.')]
    # every span of the dispatch reaches it through its parents
    assert all(_root(r, by_id).id == dispatch.id for r in inside)
    for r in log:
        if r.name.startswith('step.'):
            if r.name in ('step.h2d', 'step.launch', 'step.fetch'):
                assert r.attrs == {'step': '_trimodal_forward'}
    children = sum(r.t1 - r.t0 for r in log if r.parent == dispatch.id)
    assert children >= 0.95 * (dispatch.t1 - dispatch.t0)
    assert children <= dispatch.t1 - dispatch.t0


@pytest.mark.parametrize('broken', ['audio_path', 'image_path'])
def test_fused_b1_degraded_request_leaves_no_phases(engines, logged,
                                                    tmp_path, broken):
    """An undecodable upload ends the fused dispatch in result_unpack:
    the degraded ladder's per-modality steps run inside it, no tri-modal
    wire or step runs, and _last_b1_phases stays empty."""
    engs, reqs = engines
    eng = engs['attention']
    bad = tmp_path / 'not_media.bin'
    bad.write_bytes(b'not a wav or an image')
    req = dict(reqs[1], **{broken: str(bad)})
    out = eng.predict_multimodal(**req)
    assert out['fusion']['emotion'] in Config.EMOTIONS
    assert eng._last_b1_phases == {}
    log = logged.log()
    by_id = {r.id: r for r in log}
    names = {r.name for r in log}
    (dispatch,) = [r for r in log if r.name == 'trimodal.dispatch']
    (unpack,) = [r for r in log if r.name == 'trimodal.result_unpack']
    assert unpack.parent == dispatch.id
    assert all(_root(r, by_id).id == dispatch.id for r in log)
    assert 'request.decode' in names
    assert not any(n.startswith('trimodal.wire_encode')
                   or n == 'trimodal.dispatch_fetch' for n in names)
    steps = [r for r in log if r.name.startswith('step.')]
    assert steps and all(r.attrs.get('step') != '_trimodal_forward'
                         for r in steps if r.attrs)
    for r in steps:     # the ladder's steps sit inside result_unpack
        while r.parent != dispatch.id:
            r = by_id[r.parent]
        assert r.id == unpack.id
    # the image is not decoded after a failed audio decode
    assert ('request.decode.image' in names) == (broken == 'image_path')


@pytest.mark.parametrize('mode', ['attention', 'rf'])
def test_fused_b1_reads_its_phases_off_the_spans(engines, logged, mode):
    engs, reqs = engines
    eng = engs[mode]
    eng.predict_multimodal(**reqs[0])
    assert set(eng._last_b1_phases) == B1_KEYS
    log = logged.log()
    by_id = _check_tree(log)
    names = {r.name for r in log}
    assert names >= set(PARENT_OF) | DISPATCH_CHILDREN - {
        'trimodal.decode_stage_ms'} | {'trimodal.dispatch', 'request.decode'}
    (dispatch,) = [r for r in log if r.name == 'trimodal.dispatch']
    assert dispatch.attrs == {'rows': 1, 'bucket': 1}
    assert all(_root(r, by_id).id == dispatch.id for r in log)
    ms = {r.name: (r.t1 - r.t0) * 1e3 for r in log}
    ph = eng._last_b1_phases
    assert ph['wav_load'] == pytest.approx(ms['request.decode.speech'])
    assert ph['image_load'] == pytest.approx(ms['request.decode.image'])
    assert ph['tokenize'] == pytest.approx(ms['trimodal.wire_encode.text'])
    assert ph['wire_encode'] == pytest.approx(
        ms['trimodal.wire_encode'] - ms['trimodal.wire_encode.text'])
    assert ph['dispatch_fetch'] == pytest.approx(
        ms['trimodal.dispatch_fetch'])
    assert ph['result_unpack'] == pytest.approx(ms['trimodal.result_unpack'])
    assert sum(ph.values()) <= ms['trimodal.dispatch']


def test_single_modality_steps_take_the_step_spans(engines, logged):
    engs, reqs = engines
    eng = engs['attention']
    eng.predict_texts(['i am so happy today'])
    eng.predict_image_paths([reqs[0]['image_path']])
    steps = [(r.name, r.attrs['step']) for r in logged.log()
             if r.name in ('step.h2d', 'step.launch', 'step.fetch')]
    assert steps == [(n, s) for s in ('_text_forward', '_image_forward')
                     for n in ('step.h2d', 'step.launch', 'step.fetch')]


def test_aggregates_stay_on_with_the_log_off(engines):
    """/api/metrics' stages and totals see the phases without the log."""
    engs, reqs = engines
    eng = engs['rf']
    timer.reset()
    eng.predict_multimodal_batch([eng.predecode_multimodal(r)
                                  for r in reqs[:2]])
    tot = timer.totals()
    assert timer.log() == []
    for name in ('trimodal.dispatch', 'trimodal.wire_encode',
                 'trimodal.dispatch_fetch', 'step.launch.fusion',
                 'request.decode'):
        assert name in timer.summary()
    assert tot['request.decode']['count'] == 2
    assert tot['trimodal.dispatch']['count'] == 1
    # dispatch_fetch is _run alone: the wire is its sibling, not inside
    assert tot['trimodal.dispatch_fetch']['sum_ms'] + \
        tot['trimodal.wire_encode']['sum_ms'] <= \
        tot['trimodal.dispatch']['sum_ms']
    timer.reset()


# ----------------------------------------------------------------------
# CUDA graphs (serving/graphs.py): what the CPU shows of them
# ----------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['attention', 'rf'])
def test_cpu_warmup_captures_nothing_and_steps_run_eagerly(engines, logged,
                                                           mode):
    engs, reqs = engines
    eng = engs[mode]
    eng.warmup((1,))
    assert len(eng._graphs) == 0
    logged.reset()
    pre = [eng.predecode_multimodal(r) for r in reqs[:2]]
    args = eng._trimodal_wire([p['wave'] for p in pre],
                              [p['text'] for p in pre],
                              [p['image'] for p in pre], 8)
    got = eng._run('_trimodal_forward', *args)
    (x,) = eng._blocks(args)
    np.testing.assert_array_equal(got, eng._trimodal_forward(*x).numpy())
    names = {r.name for r in logged.log()}
    assert 'step.replay' not in names
    assert {'step.h2d', 'step.launch', 'step.fetch', 'step.launch.speech',
            'step.launch.text', 'step.launch.image',
            'step.launch.fusion'} <= names


def _step_args(rows=8, seq=32, ids=torch.int32, pcm=torch.uint8):
    """Device arguments shaped like the tri-modal step's: an audio wire
    (packed, scale), ids, mask and an image wire (Y, UV)."""
    return [(torch.zeros(rows, 99, dtype=pcm), torch.zeros(rows, 1)),
            torch.zeros(rows, seq, dtype=ids),
            torch.zeros(rows, seq, dtype=ids),
            (torch.zeros(rows, 4, 4, dtype=torch.uint8),
             torch.zeros(rows, 2, 2, 2, dtype=torch.uint8))]


@pytest.mark.parametrize('step,other', [
    ('_trimodal_forward', dict(seq=16)),
    ('_trimodal_forward', dict(seq=128)),
    ('_trimodal_forward', dict(rows=32)),
    ('_trimodal_forward', dict(ids=torch.int64)),
    ('_trimodal_forward', dict(pcm=torch.int16)),
    ('_text_forward', {})])
def test_graph_key_separates_shapes_dtypes_and_steps(step, other):
    graphs = StepGraphs()
    graphs._graphs['_trimodal_forward', signature(_step_args())] = 'g'
    assert graphs.get('_trimodal_forward', _step_args()) == 'g'
    if step == '_trimodal_forward':
        assert signature(_step_args(**other)) != signature(_step_args())
    assert graphs.get(step, _step_args(**other)) is None


@pytest.fixture(scope='module')
def bf16_engine(tmp_path_factory):
    """A tiny bf16 (int8-static) CPU engine on two replicas."""
    d = str(tmp_path_factory.mktemp('models_bf16'))
    write_synthetic_artifacts(d, tiny=True, image_size=32)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield EmotionEngine.from_models_dir(d, compute_dtype='bfloat16',
                                            device='cpu', mesh=['cpu', 'cpu'])
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize('what', ['bert', 'image'])
def test_recalibration_drops_every_replicas_graphs(bf16_engine, what):
    eng = bf16_engine
    assert len(eng.replicas) == 2
    assert eng.replicas[1]._graphs is not eng._graphs
    # the scales come back from the cache: a calibrated tree is not
    # calibrated again
    art = getattr(eng, what)
    key = getattr(eng, f'_{what}_scales_key')()
    art['meta'] = dict(art['meta'], int8_scales={
        key: extract_static_scales(art['variables'])})
    for rep in eng.replicas:
        rep._graphs._graphs['_trimodal_forward', ()] = 'g'
        assert len(rep._graphs) == 1
    getattr(eng, f'_calibrate_{what}_static')()
    assert [len(rep._graphs) for rep in eng.replicas] == [0, 0]
