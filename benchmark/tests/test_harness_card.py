"""On the card only (the cuda marker; skipped elsewhere from inside the
fixture): one short run of each configuration's open-loop cell answers
correctly, and a second run of the same cell finds every kernel built."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the benchmark runs on the card')


def _run(cell, seed):
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        cell, '--seed', str(seed), '--seconds', '5'],
                       capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize('cell', ['resnet50_bert_attn.one_client',
                                  'mobilenetv2_bert_rf.one_client'])
def test_cell_on_the_card(card, cell):
    first, second = _run(cell, 2 ** 31 + 17), _run(cell, 2 ** 31 + 18)
    for r in (first, second):
        assert r['correct'] and r['device']['platform'] == 'gpu'
    assert second['metrics']['setup_s']['value'] < 60
