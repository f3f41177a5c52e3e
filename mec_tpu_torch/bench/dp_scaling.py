#!/usr/bin/env python3
"""Data-parallel training across the visible GPUs: correctness and time.

    python3 -m mec_tpu_torch.bench.dp_scaling [--ranks 1,2,4] [--steps 8]
        [--device cpu --tiny]

For each rank count N in --ranks (every N must be at most the visible
GPUs: the data axis is never shrunk) it starts N ranks with
parallel.launch (NCCL, one GPU a rank; gloo for --device cpu) and on
them:

* check: one float64 step of the fusion net on each rank's rows of one
  global batch of 16 against the same step in one process on all rows,
  after the all-reduce (max |error| of the gradients the optimizer is
  handed; the data-parallel contract, tests/test_torch_parallel.py);
* all-reduce: CUDA-event medians of parallel.mesh.DataMesh.all_reduce_
  (mean, in place) on fp32 buffers of 64 and 440 MiB (440 MiB: BERT-base's
  gradients), and the bus rate 2 (N - 1) / N x bytes / time;
* step: BERT-base (12 x 768, fp32, seq 128, 16 rows a rank: a global
  batch of 16 N) through train_text_bert.make_steps and the AdamW of the
  trainer: the CUDA-event median of --steps steps after 3 warm-up steps
  (each includes the gradient all-reduce in TrainState.apply_gradients,
  under parallel.mesh.data_parallel), samples/s over the global batch,
  and the scaling against N = 1.

Prints one line a rank count and the card's name and power limit. --tiny
shrinks the buffers and BERT (2 layers of width 64) to rehearse on the
CPU with gloo ranks.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch


def _timed(fn, reps, device):
    """Median milliseconds of fn() after 2 warm-up calls: CUDA events on
    a card, the host clock on the CPU."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        if device.type == 'cuda':
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def fusion_grads(device, mesh):
    """The float64 gradients the optimizer is handed after one fusion
    step on this rank's rows of a seeded global batch of 16 (all rows
    without a mesh)."""
    from mec_tpu_torch.models.fusion import MultiModalFusionModel
    from mec_tpu_torch.parallel import mesh as pmesh
    from mec_tpu_torch.training import common, train_fusion

    class Recording(common.Tx):
        def step(self, grads, state, params):
            self.grads = [g.cpu().numpy() for g in grads]
            super().step(grads, state, params)

    rng = np.random.RandomState(3)
    probs = rng.dirichlet(np.ones(7), (3, 16))
    batch = {'s_feat': rng.randn(16, 64), 't_feat': rng.randn(16, 768),
             'i_feat': rng.randn(16, 512), 's_pred': probs[0],
             't_pred': probs[1], 'i_pred': probs[2],
             'label': rng.randint(0, 7, 16)}
    model = common.flax_init(MultiModalFusionModel(dtype=torch.float64), 0)
    model = model.double().to(device)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    if mesh is not None:
        batch = mesh.shard_rows(batch)
    state = common.TrainState(model, Recording({'all': common.Adam(1e-3)}))
    model.train()
    with pmesh.data_parallel(mesh):
        train_fusion.make_steps(model)[0](state,
                                          common.to_device(batch, device))
    return state.tx.grads


def rank_main(tiny, steps):
    """One rank: the check, the all-reduce times and the BERT step."""
    from mec_tpu_torch.models.bert import BertForSequenceClassification
    from mec_tpu_torch.parallel import mesh as pmesh
    from mec_tpu_torch.training import common, train_text_bert
    import torch.distributed as dist
    n = dist.get_world_size()
    mesh = pmesh.make_mesh(n)
    device = (torch.device('cuda', torch.cuda.current_device())
              if torch.cuda.is_available() and dist.get_backend() == 'nccl'
              else torch.device('cpu'))
    got = fusion_grads(device, mesh)
    err = None
    if mesh.rank == 0:
        want = fusion_grads(device, None)
        err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    out = {'grad_err': err, 'allreduce': {}}
    for mib in ((1, 4) if tiny else (64, 440)):
        buf = torch.ones(mib * 2 ** 18, device=device)
        out['allreduce'][mib] = _timed(
            lambda: mesh.all_reduce_([buf], mean=True), 10, device)
        del buf
    kw = (dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
               intermediate_size=128) if tiny else {})
    seq = 16 if tiny else 128
    model = common.flax_init(BertForSequenceClassification(**kw), 0)
    state = common.TrainState(model.to(device), common.adamw_with_clip(
        common.cosine_decay_schedule(2e-5, 100)))
    g = torch.Generator().manual_seed(mesh.rank)
    batch = {'ids': torch.randint(5, kw.get('vocab_size', 30522), (16, seq),
                                  generator=g).to(device),
             'mask': torch.ones(16, seq, dtype=torch.int32, device=device),
             'label': torch.randint(0, 7, (16,), generator=g).to(device)}
    step = train_text_bert.make_steps(model)[0]
    model.train()
    with pmesh.data_parallel(mesh):
        out['step_ms'] = _timed(lambda: step(state, batch), steps, device)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--ranks', default='1,2,4')
    p.add_argument('--steps', type=int, default=8)
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    p.add_argument('--tiny', action='store_true')
    args = p.parse_args(argv)
    from mec_tpu_torch.parallel import launch
    if args.device == 'cuda':
        if not torch.cuda.is_available():
            raise SystemExit('no CUDA device (run with --device cpu --tiny '
                             'to rehearse on the CPU)')
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        print(f'{torch.cuda.device_count()} visible: {card}')
        card = card[0]
    else:
        card = 'cpu ranks over gloo (no device metric)'
    base = None
    for n in (int(x) for x in args.ranks.split(',')):
        devices = launch.devices_for(n, args.device)
        ranks = launch.launch(rank_main, n, args=(args.tiny, args.steps),
                              devices=devices,
                              threads=1 if args.device == 'cpu' else None,
                              timeout=900)
        err = ranks[0]['grad_err']
        if err is None or err > 1e-10:
            raise SystemExit(f'{n} ranks: averaged gradients differ from one '
                             f'process by {err}')
        ms = statistics.median(r['step_ms'] for r in ranks)
        rate = 16 * n * 1e3 / ms
        base = base or rate
        ar = []
        for mib in ranks[0]['allreduce']:
            t = statistics.median(r['allreduce'][mib] for r in ranks)
            bus = 2 * (n - 1) / n * mib * 2 ** 20 / t / 1e6
            ar.append(f'{mib} MiB {t:.3f} ms ({bus:.1f} GB/s bus)')
        ar = ', '.join(ar)
        print(f'dp {n} rank(s): gradients within {err:.2e} of one process; '
              f'all-reduce {ar}; BERT{"-tiny" if args.tiny else "-base"} '
              f'fp32 seq {16 if args.tiny else 128}, 16 rows a rank: '
              f'{ms:.3f} ms/step, {rate:.1f} samples/s, {rate / base:.2f}x '
              f'the 1-rank rate; {card}')


if __name__ == '__main__':
    main()
