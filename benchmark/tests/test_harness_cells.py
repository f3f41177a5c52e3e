"""Lookup by name: a mix added as a file, a per-layer metric added as a
reader, and their entries in BENCHMARK.json make a runnable cell in a
copy of the benchmark, with no file that was there edited. Then every
tiny cell runs end to end on the CPU and answers correctly."""

import json
import os

import pytest

from benchmark.tests.tiny import make_root, run_cell, write_spec


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp('bench')))


def test_a_new_mix_and_metric_are_files_and_entries(tmp_path):
    root = make_root(str(tmp_path))
    bench = os.path.join(root, 'benchmark')
    before = {os.path.join(d, f): open(os.path.join(d, f), 'rb').read()
              for d, _s, fs in os.walk(bench) for f in fs
              if '__pycache__' not in d}
    with open(os.path.join(bench, 'traffic', 'tiny_open.json')) as f:
        mix = json.load(f)
    mix.update(name='tiny_calm', rate_per_s=3, shape_seed=99)
    with open(os.path.join(bench, 'traffic', 'tiny_calm.json'), 'w') as f:
        json.dump(mix, f)
    with open(os.path.join(bench, 'layer_metrics',
                           'probe.answered.calm.py'), 'w') as f:
        f.write('def read(ctx):\n'
                '    return sum(1 for r in ctx.records if ctx.ok(r))\n')
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    cell = 'tiny_resnet50_bert_attn.calm'
    spec['workloads'].append({'name': cell,
                              'config': 'tiny_resnet50_bert_attn',
                              'traffic': 'tiny_calm', 'chips': 1,
                              'why': 'added as data'})
    for m in spec['end_to_end']:
        if m['name'].startswith('latency'):
            m['workloads'].append(cell)
    spec['per_layer'].append({'name': 'probe.answered.calm',
                              'unit': 'requests', 'better': 'higher',
                              'source': 'host_clock', 'layer': 'batcher',
                              'moves': 'latency_p50_ms',
                              'workloads': [cell]})
    write_spec(root, spec)
    for path, data in before.items():
        with open(path, 'rb') as f:
            assert f.read() == data, path
    rc, res, err = run_cell(root, cell, trace=0)
    assert rc == 0 and res['correct'], err[-3000:]
    assert set(res['metrics']) == {'setup_s', 'latency_p50_ms'}
    assert res['attempted'] == 3
    rc, res, err = run_cell(root, cell, trace=1)
    assert rc == 0 and res['correct'], err[-3000:]
    assert res['metrics']['probe.answered.calm']['value'] == 3


@pytest.mark.parametrize('cell,trace', [
    ('tiny_resnet50_bert_attn.open', 0),
    ('tiny_resnet50_bert_attn.one_client', 0),
    ('tiny_resnet50_bert_attn.saturated', 1),
    ('tiny_mobilenetv2_bert_rf.one_client', 1),
    ('tiny_mobilenetv2_bert_rf.saturated', 0)])
def test_tiny_cells_run_and_answer_correctly(root, cell, trace):
    rc, res, err = run_cell(root, cell, seed=2 ** 31 + 3, trace=trace)
    assert rc == 0, err[-3000:]
    assert res['correct'] and res['failed'] == 0, err[-3000:]
    assert res['device']['platform'] == 'cpu'
    assert list(res)[-1] == 'check'
    want = ({'setup_s', 'latency_p50_ms'}
            if cell.endswith(('one_client', 'open'))
            else {'setup_s', 'preds_per_s'})
    if trace:
        assert 'setup_s' not in res['metrics']
    else:
        assert set(res['metrics']) == want


def test_no_card_no_result(root):
    """Without --device cpu (the tests' own door) a run needs CUDA."""
    import subprocess
    import sys
    p = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        'tiny_resnet50_bert_attn.one_client', '--seed', '1',
                        '--seconds', '1'], capture_output=True, text=True,
                       cwd=root, env=dict(os.environ, CUDA_VISIBLE_DEVICES='',
                                          PYTHONPATH=os.path.dirname(
                                              os.path.dirname(os.path.dirname(
                                                  os.path.abspath(
                                                      __file__))))))
    assert p.returncode != 0 and p.stdout.strip() == ''


def test_only_the_benchmark_is_no_program(tmp_path):
    """A checkout holding BENCHMARK.json and benchmark/ alone has no
    program to run: the run fails and prints no result."""
    import subprocess
    import sys
    root = make_root(str(tmp_path))
    p = subprocess.run([sys.executable, '-c',
                        'import sys; sys.path.insert(0, %r)\n'
                        'from benchmark import run\n'
                        'sys.exit(run.main(["--workload", '
                        '"tiny_resnet50_bert_attn.one_client", "--seed", "1", '
                        '"--seconds", "1"], device="cpu"))' % root],
                       capture_output=True, text=True, cwd=root,
                       env={k: v for k, v in os.environ.items()
                            if k != 'PYTHONPATH'})
    assert p.returncode != 0 and p.stdout.strip() == ''
    assert 'mec_tpu_torch' in p.stderr
