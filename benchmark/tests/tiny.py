"""A copy of the benchmark at tiny sizes, for runs on the CPU.

make_root(dest) copies benchmark/ into dest and writes a BENCHMARK.json
whose cells are the real ones' tiny twins (`tiny_<cell>`) over tiny
twins of every configuration (each leg at its TINY widths: BERT 2 layers
of width 64, images at 32 px; an 8-tree forest; the limits of the
configuration's `tiny_check`) and tiny mixes (a pool of 6 clips and 6
photos, at most 4 clients, a one-second window), one open-loop cell
(OPEN_CELL, 6 requests a second), and the twins of the cells of 64
clients that the benchmark no longer measures (SATURATED). run_cell runs one
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

from benchmark.harness.cells import leg

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

OPEN_CELL = 'tiny_resnet50_bert_attn.open'
# the cells of 64 clients and their metrics, as the benchmark had them: it
# measures no such cell (PERF.md: their rates spread too widely from run
# to run for a bound), and the tiny copy adds them back as entries, as a
# later change may, so the tests keep the batched path, its control and
# its faults
SATURATED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         'saturated_cells.json')


def _tiny_config(bench: str, name: str) -> dict:
    """The configuration `name` of the benchmark at `bench` with its legs'
    tiny widths (each leg's TINY), the fusion's text width at the tiny
    text's, an 8-tree forest, and the limits of its `tiny_check` table:
    set from the tiny copy's own CPU readings (4 seeds of each cell, 3 of
    the control), with room, since these sizes are not the cells', whose
    limits are the configuration's `check`."""
    with open(os.path.join(bench, 'configs', name + '.json')) as f:
        cfg = json.load(f)
    cfg['name'] = 'tiny_' + name
    for kind in ('text', 'image'):
        cfg[kind] = dict(cfg[kind], **leg(cfg, kind, bench).TINY)
    cfg['check'] = cfg.pop('tiny_check')
    if cfg['fusion']['kind'] == 'attention':
        cfg['fusion'] = dict(cfg['fusion'],
                             text_dim=cfg['text']['hidden_size'])
    else:
        cfg['fusion'] = dict(cfg['fusion'], n_estimators=8, max_depth=6)
    return cfg


def _tiny_mix(name: str, bench: str = BENCH) -> dict:
    with open(os.path.join(bench, 'traffic', name + '.json')) as f:
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


def make_root(dest: str, src: str = REPO) -> str:
    """The tiny copy of the benchmark at `src` (BENCHMARK.json and
    benchmark/), written to `dest`: a tiny twin of every configuration,
    mix and cell."""
    bench = os.path.join(src, 'benchmark')
    shutil.copytree(bench, os.path.join(dest, 'benchmark'),
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))
    with open(os.path.join(src, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    for c in [entry['name'] for entry in spec['configs']]:
        with open(os.path.join(dest, 'benchmark', 'configs',
                               f'tiny_{c}.json'), 'w') as f:
            json.dump(_tiny_config(bench, c), f)
        shutil.copy(os.path.join(bench, 'flops', c + '.py'),
                    os.path.join(dest, 'benchmark', 'flops', f'tiny_{c}.py'))
    with open(SATURATED) as f:
        mixes = {w['traffic'] for w in spec['workloads'] + json.load(f)[
            'workloads']}
    for m in mixes:
        with open(os.path.join(dest, 'benchmark', 'traffic',
                               f'tiny_{m}.json'), 'w') as f:
            json.dump(_tiny_mix(m, bench), f)
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
    add_entries(spec, SATURATED)
    write_spec(dest, spec)
    return dest


def add_entries(spec: dict, path: str) -> None:
    """Add the cells and metrics of the file at `path` (BENCHMARK.json's
    keys), as tiny twins, to the tiny spec where it lacks them."""
    with open(path) as f:
        extra = json.load(f)
    have = {w['name'] for w in spec['workloads']}
    for w in extra['workloads']:
        if 'tiny_' + w['name'] not in have:
            spec['workloads'].append(dict(
                w, name='tiny_' + w['name'], config='tiny_' + w['config'],
                traffic='tiny_' + w['traffic']))
    for key in ('end_to_end', 'per_layer'):
        mine = {m['name']: m for m in spec[key]}
        for m in extra[key]:
            cells = ['tiny_' + w for w in m['workloads']]
            if m['name'] in mine:
                mine[m['name']]['workloads'] += [
                    w for w in cells if w not in mine[m['name']]['workloads']]
            else:
                spec[key].append(dict(m, workloads=cells))


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
