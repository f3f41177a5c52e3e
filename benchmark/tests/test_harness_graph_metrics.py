"""The readers of the model step's CUDA-graph share
(step.graph_share.one_client and .saturated) on hand-made StageTimer
summaries: 100 where every step.launch holds a step.replay, 0 where none
does, a part in between, and nothing where the program has no
step.launch span."""

import pytest

from benchmark.harness.cells import Cell
from benchmark.run import Context

METRICS = ('step.graph_share.one_client', 'step.graph_share.saturated')


def read(metric, timer):
    return Cell('resnet50_bert_attn.one_client').reader(metric).read(
        Context(timer=timer))


@pytest.mark.parametrize('metric', METRICS)
@pytest.mark.parametrize('replays,share', [(40, 100.0), (10, 25.0),
                                           (None, 0.0)])
def test_reads_the_share_of_steps_that_replayed(metric, replays, share):
    timer = {'step.launch': {'count': 40, 'p50_ms': 1.5},
             'step.h2d': {'count': 40, 'p50_ms': 0.1}}
    if replays is not None:
        timer['step.replay'] = {'count': replays, 'p50_ms': 1.2}
    assert read(metric, timer) == pytest.approx(share)


@pytest.mark.parametrize('metric', METRICS)
def test_reads_nothing_without_the_step_span(metric):
    assert read(metric, {'trimodal.dispatch': {'count': 3,
                                               'p50_ms': 9.0}}) is None
    assert read(metric, {}) is None
