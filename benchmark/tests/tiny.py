"""A copy of the benchmark at tiny sizes, for runs on the CPU.

make_root(dest) copies benchmark/ into dest and writes a BENCHMARK.json
whose cells are the real ones' tiny twins (`tiny_<cell>`) over tiny
configurations (the real ones with a 2-layer BERT of width 64 and 32 px
images; an 8-tree forest) and tiny mixes (a pool of 6 clips and 6
photos, at most 4 clients, a one-second window), and one open-loop cell
(OPEN_CELL, 6 requests a second). run_cell runs one
cell of such a copy in a fresh interpreter on the CPU, the harness's look
for a card skipped, and returns (exit code, the result or None, stderr).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

# limits of the tiny copies, from their own CPU readings (bf16 and int8
# at a 2-layer width-64 BERT and 32 px images: 4 seeds of each cell, and
# 3 of the control), with room: these sizes are not the cells', whose
# limits are the configurations' own
TINY_CHECK = {
    'resnet50_bert_attn': {'speech_logit_median_gap': 5e-4,
                           'text_logit_mean_gap': 0.8,
                           'image_logit_mean_gap': 0.5,
                           'image_gap': 0.15,
                           'fusion_logit_mean_gap': 0.1},
    'mobilenetv2_bert_rf': {'speech_logit_median_gap': 1e-4,
                            'text_logit_mean_gap': 0.8,
                            'image_logit_mean_gap': 3.5,
                            'fusion_gap': 1e-5}}

OPEN_CELL = 'tiny_resnet50_bert_attn.open'

TINY_TEXT = {'vocab_size': 30522, 'hidden_size': 64, 'num_hidden_layers': 2,
             'num_attention_heads': 2, 'intermediate_size': 128,
             'max_position_embeddings': 128}


def _tiny_config(name: str) -> dict:
    with open(os.path.join(BENCH, 'configs', name + '.json')) as f:
        cfg = json.load(f)
    cfg['name'] = 'tiny_' + name
    cfg['text'] = dict(cfg['text'], **TINY_TEXT)
    cfg['image'] = dict(cfg['image'], img_size=32)
    cfg['check'] = TINY_CHECK[name]
    if cfg['fusion']['kind'] == 'attention':
        cfg['fusion'] = dict(cfg['fusion'], text_dim=64)
    else:
        cfg['fusion'] = dict(cfg['fusion'], n_estimators=8, max_depth=6)
    return cfg


def _tiny_mix(name: str) -> dict:
    with open(os.path.join(BENCH, 'traffic', name + '.json')) as f:
        mix = json.load(f)
    mix.update(name='tiny_' + name, warmup_buckets=[1, 8],
               warmup_requests=3, check_requests=24, trace_seconds=0.5,
               drain_seconds=60, clients=min(4, mix['clients']),
               max_requests_per_s=40,
               audio=dict(mix['audio'], pool=6, seconds=[1, 2]),
               image=dict(mix['image'], pool=6, width=64, height=48))
    return mix


def open_mix() -> dict:
    """A tiny open-loop mix (Poisson arrivals at 6 a second), which no
    cell of the benchmark uses yet and the tests keep working."""
    mix = _tiny_mix('one_client')
    mix.update(name='tiny_open', loop='open', rate_per_s=6, workers=8)
    return mix


def make_root(dest: str) -> str:
    shutil.copytree(BENCH, os.path.join(dest, 'benchmark'),
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))
    with open(os.path.join(REPO, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    for c in ('resnet50_bert_attn', 'mobilenetv2_bert_rf'):
        with open(os.path.join(dest, 'benchmark', 'configs',
                               f'tiny_{c}.json'), 'w') as f:
            json.dump(_tiny_config(c), f)
        shutil.copy(os.path.join(BENCH, 'flops', c + '.py'),
                    os.path.join(dest, 'benchmark', 'flops', f'tiny_{c}.py'))
    for m in {w['traffic'] for w in spec['workloads']}:
        with open(os.path.join(dest, 'benchmark', 'traffic',
                               f'tiny_{m}.json'), 'w') as f:
            json.dump(_tiny_mix(m), f)
    with open(os.path.join(dest, 'benchmark', 'traffic', 'tiny_open.json'),
              'w') as f:
        json.dump(open_mix(), f)
    # each cell's tiny twin: tiny_<cell> over tiny_<config>, tiny_<mix>;
    # and an open-loop cell reporting the latencies
    for w in spec['workloads']:
        w.update(name='tiny_' + w['name'], config='tiny_' + w['config'],
                 traffic='tiny_' + w['traffic'])
    for m in spec['end_to_end'] + spec['per_layer']:
        if 'workloads' in m:
            m['workloads'] = ['tiny_' + w for w in m['workloads']]
            if m['name'].startswith('latency'):
                m['workloads'].append(OPEN_CELL)
    spec['workloads'].append({'name': OPEN_CELL,
                              'config': 'tiny_resnet50_bert_attn',
                              'traffic': 'tiny_open', 'chips': 1,
                              'why': 'the open loop'})
    write_spec(dest, spec)
    return dest


def write_spec(root: str, spec: dict) -> None:
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(spec, f, indent=1)


def run_cell(root: str, workload: str, seed: int = 7, trace: int = 0,
             fault: Optional[str] = None, timeout: float = 600):
    """fault: a function name in benchmark/tests/faults.py, applied to the
    engine before the window."""
    code = ('import sys; sys.path[:0] = [%r, %r]\n'
            'from benchmark import run\n'
            'fault = None\n' % (root, REPO))
    if fault:
        code += ('from benchmark.tests import faults\n'
                 'fault = faults.%s\n' % fault)
    code += ('sys.exit(run.main(%r, device="cpu", fault=fault))\n'
             % ['--workload', workload, '--seed', str(seed), '--seconds',
                '1', '--trace', str(trace)])
    env = dict(os.environ, OMP_NUM_THREADS='2', MKL_NUM_THREADS='2')
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=root)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, result, p.stderr
