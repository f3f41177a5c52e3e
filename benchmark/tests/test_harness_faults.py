"""The check catches a broken timed path: a run of a tiny cell with a
fault planted under predict_multimodal_batch comes out not correct, for
each fault a serving cell can have on one card: an answer altered where
it is produced (one a dispatch), and half of a dispatch left out (its
other half's answers returned for it); a one-client cell's dispatches
hold one request, so half of one leaves nothing out."""

import pytest

from benchmark.tests.tiny import make_root, run_cell


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp('bench')))


@pytest.mark.parametrize('cell,fault', [
    ('tiny_resnet50_bert_attn.one_client', 'alter_answer'),
    ('tiny_mobilenetv2_bert_rf.one_client', 'alter_answer'),
    ('tiny_resnet50_bert_attn.saturated', 'alter_answer'),
    ('tiny_mobilenetv2_bert_rf.saturated', 'alter_answer'),
    ('tiny_resnet50_bert_attn.saturated', 'half_batch'),
    ('tiny_mobilenetv2_bert_rf.saturated', 'half_batch')])
def test_a_fault_is_not_correct(root, cell, fault):
    rc, res, err = run_cell(root, cell, seed=11, fault=fault)
    assert rc == 0, err[-3000:]
    assert res['correct'] is False
    over = [k for k, v in res['check'].items()
            if v['value'] is not None and v['value'] > v['limit']]
    assert over, res['check']
