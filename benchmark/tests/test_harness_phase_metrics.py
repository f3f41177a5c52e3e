"""The readers of the program's own phase spans (the engine's StageTimer
names): on hand-made timer summaries, and in traced tiny runs on the
CPU, where the program's spans are all they need."""

import pytest

from benchmark.harness.cells import Cell
from benchmark.run import Context
from benchmark.tests.tiny import make_root, run_cell

CELL = Cell('resnet50_bert_attn.one_client')


def reader(name):
    return CELL.reader(name)


@pytest.mark.parametrize('metric,span', [
    ('step.launch_ms.one_client', 'step.launch'),
    ('engine.wire_ms.saturated', 'trimodal.wire_encode')])
def test_reads_the_median_of_the_programs_span(metric, span):
    ctx = Context(timer={span: {'count': 9, 'p50_ms': 31.5},
                         'other': {'count': 1, 'p50_ms': 2.0}})
    assert reader(metric).read(ctx) == 31.5
    # a program without the span (the parent of the change that named
    # it) reads nothing, and does not raise
    assert reader(metric).read(Context(timer={'other': {'p50_ms': 1}})) \
        is None


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp('bench')))


@pytest.mark.parametrize('cell,metric', [
    ('tiny_resnet50_bert_attn.one_client', 'step.launch_ms.one_client'),
    ('tiny_mobilenetv2_bert_rf.saturated', 'engine.wire_ms.saturated')])
def test_traced_tiny_runs_report_them(root, cell, metric):
    rc, res, err = run_cell(root, cell, seed=2 ** 31 + 11, trace=1)
    assert rc == 0, err[-3000:]
    assert res['correct'], err[-3000:]
    assert res['metrics'][metric]['value'] > 0
    assert res['metrics'][metric]['unit'] == 'ms'
