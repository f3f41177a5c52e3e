"""Everything a cell is made of, found by name: the entry of
BENCHMARK.json, benchmark/configs/<config>.json,
benchmark/traffic/<traffic>.json, benchmark/end_to_end/<metric>.py,
benchmark/layer_metrics/<metric>.py,
benchmark/flops/<config>.py, benchmark/bounds/<kernel>.py, the
config's text and image legs under benchmark/legs/ and its reference
pieces under benchmark/reference/. Adding any of them is adding files
and entries: nothing here names one."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def leg(cfg: Dict, kind: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """A configuration's text or image leg (kind 'text' or 'image'):
    <bench_dir>/legs/<kind>_<arch>.py, arch from the config's table. A
    leg has plan(d, **table), its weight tree (trees.Draws leaves, numpy
    constants or seeded.Leaf recipes); optionally post(tree), applied to
    the drawn tree; TINY, the widths of its tiny copy (tests/tiny.py);
    and a text leg engine_kwargs(text, tree, vocab), the keywords that
    hand its tree to the port's EmotionEngine."""
    name = f'{kind}_{cfg[kind]["arch"]}'
    return _module(os.path.join(bench_dir, 'legs', name + '.py'),
                   'leg_' + name)


class Cell:
    def __init__(self, workload: str, root: str = ROOT):
        self.root = root
        self.bench_dir = os.path.join(root, 'benchmark')
        self.spec = _json(os.path.join(root, 'BENCHMARK.json'))
        cells = {w['name']: w for w in self.spec['workloads']}
        if workload not in cells:
            raise SystemExit(f'unknown workload {workload!r}; have '
                             f'{sorted(cells)}')
        self.entry = cells[workload]
        self.name = workload
        self.config = _json(os.path.join(self.bench_dir, 'configs',
                                         self.entry['config'] + '.json'))
        self.mix = _json(os.path.join(self.bench_dir, 'traffic',
                                      self.entry['traffic'] + '.json'))

    def end_to_end(self) -> List[Dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec['end_to_end']
                if self.name in m.get('workloads', [self.name])]

    def per_layer(self) -> List[Dict]:
        """The per-layer metrics of this cell: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        mine = {m['name'] for m in self.end_to_end()}
        return [m for m in self.spec['per_layer']
                if (self.name in m['workloads'] if 'workloads' in m
                    else m['moves'] in mine)]

    def reader(self, metric: str, kind: str = 'layer_metrics'
               ) -> ModuleType:
        """The reader of a metric: benchmark/layer_metrics/<name>.py, or
        with kind='end_to_end' benchmark/end_to_end/<name>.py."""
        return _module(os.path.join(self.bench_dir, kind, metric + '.py'),
                       f'{kind}_' + metric.replace('.', '_'))

    def flops(self) -> ModuleType:
        return _module(os.path.join(self.bench_dir, 'flops',
                                    self.entry['config'] + '.py'),
                       'flops_' + self.entry['config'])

    def bounds(self) -> Dict[str, ModuleType]:
        """Every kernel bound file, by file name."""
        return {os.path.basename(p)[:-3]: _module(p, 'bound_' + os.path.
                                                   basename(p)[:-3])
                for p in sorted(glob.glob(os.path.join(
                    self.bench_dir, 'bounds', '*.py')))}
