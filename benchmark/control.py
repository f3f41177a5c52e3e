"""The control of a cell's output check: the reference put in the program's
place, computed one step below the configuration's stated precision
(benchmark/reference/precision.py, the configuration's "precision"
table), and judged as a run judges the program: the same sample of the
same traffic, the same numbers, against the float32 reference.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

Prints, per seed, the compared numbers as one JSON line, and the cell's
limits. No window is needed: the control is a function of the inputs,
which the traffic draws from the seed as a run does. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import check  # noqa: E402
from benchmark.harness import traffic as tr  # noqa: E402
from benchmark.harness.cells import Cell  # noqa: E402
from benchmark.harness.vocab import build_vocab  # noqa: E402
from benchmark.reference.pipeline import Reference  # noqa: E402
from benchmark.reference.precision import Prec  # noqa: E402
from benchmark.weights.trees import make_trees  # noqa: E402


def readings(cell: Cell, seed: int, device, seconds: float = 30.0):
    """The control's numbers on one seed: the first `check_requests` of
    the window's traffic (with the longest text) answered by the control
    and judged by the float32 reference."""
    cfg, mix = cell.config, cell.mix
    vocab, words = build_vocab(cfg['text']['vocab_size'])
    workdir = tempfile.mkdtemp(prefix='mec-control-')
    try:
        traffic = tr.build(mix, seed, seconds, words, workdir, device)
        reqs = traffic.timed
        rng = tr._stream(seed, 3)
        longest = max(range(len(reqs)), key=lambda i: reqs[i].n_words)
        picked = [reqs[i] for i in check.sample(
            len(reqs), mix['check_requests'], rng, [longest])]
        trees = make_trees(cfg, seed, device)
        control = Reference(cfg, trees, vocab, device, Prec(cfg['precision']))
        answers = [{k: {'all_probabilities': [float(x) for x in a[k]]}
                    for k in check.MODALITIES}
                   for a in control.run(picked)]
        del control
        exact = Reference(cfg, trees, vocab, device)
        return check.gaps(answers, exact.run(picked, answers))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None, device: str = 'cuda') -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    args = ap.parse_args(argv)
    if device == 'cuda':
        if not torch.cuda.is_available():
            print('no CUDA device', file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell = Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(',')):
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'control': readings(cell, seed,
                                              torch.device(device)),
                          'limits': cell.config['check']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
