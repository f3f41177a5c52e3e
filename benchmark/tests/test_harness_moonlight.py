"""moonlight16b_resnet50_attn's tiny twin on the CPU (benchmark/tests/
tiny.py: 1 dense + 2 expert layers, 16 experts, top 6, 2 shared, small
MLA dims): it runs and answers correctly, traced and untraced, with the
new per-layer metrics read from the program's counters; the fp8 control
fails its check; and a fault in the text leg (the shared experts left
out, or the routing weights left unnormalised) fails it."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.tiny import REPO, make_root, run_cell

CELL = 'tiny_moonlight16b_resnet50_attn.one_client'
NEW = ('moe.experts_touched.one_client', 'moe.expert_gemm_roofline.one_client',
       'moe.expert_gemm_device_share.one_client')


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp('bench')))


@pytest.mark.parametrize('trace', [0, 1])
def test_the_tiny_cell_runs_and_answers_correctly(root, trace):
    rc, res, err = run_cell(root, CELL, seed=2 ** 31 + 17, trace=trace)
    assert rc == 0, err[-3000:]
    assert res['correct'] and res['failed'] == 0, err[-3000:]
    if trace:
        # the routing counter is the program's; the kernel's device
        # metrics have no trace to read on the CPU
        touched = res['metrics']['moe.experts_touched.one_client']['value']
        assert 0 < touched <= 16
        assert not set(NEW[1:]) & set(res['metrics'])
        assert res['metrics']['step.graph_share.one_client']['value'] == 0
    else:
        assert set(res['metrics']) == {'setup_s', 'latency_p50_ms'}


def test_the_control_fails_the_check(root):
    code = ('import sys; sys.path[:0] = [%r, %r]\n'
            'from benchmark import control\n'
            'sys.exit(control.main(["--workload", %r, "--seeds", "21,22"],'
            ' device="cpu"))' % (root, REPO, CELL))
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=root, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert p.returncode == 0, p.stderr[-3000:]
    for line in p.stdout.strip().splitlines():
        r = json.loads(line)
        assert r['control']['text_logit_mean_gap'] \
            > r['limits']['text_logit_mean_gap'], r


FAULTS = '''
import torch


def no_shared_experts(engine):
    """The text leg's shared experts left out of every expert layer."""
    for layer in engine.text_leg.model.tree['layers'].values():
        sh = layer['mlp'].get('shared_experts')
        if sh is not None:
            sh['down_proj']['weight'] = torch.zeros_like(
                sh['down_proj']['weight'])
    engine._drop_graphs()


def unnormalised_routing(engine):
    """The chosen experts' scores left unnormalised (norm_topk_prob off)."""
    engine.text_leg.model.cfg['norm_topk_prob'] = False
    engine._drop_graphs()
'''


@pytest.mark.parametrize('fault', ['no_shared_experts',
                                   'unnormalised_routing'])
def test_a_fault_in_the_text_leg_is_not_correct(root, fault, tmp_path):
    with open(os.path.join(str(tmp_path), 'text_faults.py'), 'w') as f:
        f.write(FAULTS)
    code = ('import sys; sys.path[:0] = [%r, %r, %r]\n'
            'from benchmark import run\n'
            'import text_faults\n'
            'sys.exit(run.main(%r, device="cpu", fault=text_faults.%s))\n'
            % (str(tmp_path), root, REPO,
               ['--workload', CELL, '--seed', '11', '--seconds', '1'],
               fault))
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=600, cwd=root,
                       env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res['correct'] is False
    assert res['check']['text_logit_mean_gap']['value'] \
        > res['check']['text_logit_mean_gap']['limit'], res['check']
