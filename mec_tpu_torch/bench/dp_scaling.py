#!/usr/bin/env python3
"""Data parallelism across the visible GPUs, and the BERT model and pipe
axes: correctness and time.

    python3 -m mec_tpu_torch.bench.dp_scaling [--ranks 1,2,4] [--steps 8]
        [--serve 1,2,4] [--layouts 1x1x1,1x2x1,...] [--device cpu --tiny]

--ranks: for each rank count N (every N must be at most the visible
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

--serve: serving data parallelism. A full-width models directory
(serving/synthetic_artifacts: BERT-base, ResNet50 224 px, attention
fusion) served by one engine a card count N (EmotionEngine(mesh=
cuda:0 .. cuda:N-1)) in bf16 and fp32 beside a single-card engine
(mesh=None): fp32 tri-modal rows at B = 1, 8, 32 within 1e-5 of one card;
bf16 rows of each replica bit for bit those of the single-card engine fed
the same rows at the same per-replica bucket, and the whole within
SERVE_DP_BAND of one card; the host wall of a tri-modal dispatch
(_run_trimodal: wire encode, the replicas' steps, the gather) at B = 1
and 32 (median of 20, in turns with run_threaded, the dispatch from a
thread a replica that the engine does not use) and each card's device
busy time a dispatch (its kernels in a torch.profiler window).

--layouts DxMxP[s|eE] ...: the BERT trainer's mesh layouts (data x model
x pipe; s: sequence parallelism; eE: an MoE BERT of E experts, expert
parallelism over 'model'), each in D*M*P ranks over NCCL: one float64
step of BERT-base (seq 128, 8 rows a data rank) whose gradients after
the reduce, gathered to the whole tree (parallel/partition.
gather_state), are held against one process on the global batch (rank
0 runs it) within 1e-10 of the largest gradient, with the loss and the
clip's norm; then the fp32 step's CUDA-event median (16 rows a data
rank, --steps steps after 3 warm-up steps; the pipeline with
--microbatches 4 and remat, as JAX's pipeline runs) and samples/s.

Prints one line a rank count, card count or layout, and the card's name
and power limit. --tiny shrinks the buffers and BERT (2 layers of width
64; 4 heads for the layouts) to rehearse on the CPU with gloo ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

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
        def step(self, grads, state, params, norm_fn=None):
            self.grads = [g.cpu().numpy() for g in grads]
            super().step(grads, state, params, norm_fn)

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


# ----------------------------------------------------------------------
# serving data parallelism
# ----------------------------------------------------------------------

# bf16 tri-modal rows of N replicas against one card: the per-replica
# batch has another shape, so the bf16 GEMMs and LayerNorms may round one
# step apart and move an int8 code downstream. Set from the readings on
# NVIDIA H100 80GB HBM3 at 700 W (full-width synthetic directory, B = 1,
# 8, 32): 1.515e-03 with two replicas sharing one card (chip_smoke.py
# phase 6e), 7.22e-03 on four cards (--serve 1,2,4); about 3x the larger.
# Each replica's rows are held bit for bit besides.
SERVE_DP_BAND = 2e-2
SERVE_TEXTS = ['i am so happy today', 'this is terrible and sad',
               'wow what a surprise', 'i feel angry about all of this',
               'the day was calm', 'i hate this awful news']


def serve_inputs(B, size, seed=0):
    """Seeded clips (tones and noise), texts and images (noise, ramps)."""
    rng = np.random.RandomState(seed)
    t = np.arange(66150) / 22050.0
    waves = np.stack([0.2 * np.sin(2 * np.pi * (150 + 37 * i) * t)
                      + 0.01 * (i % 3) * rng.randn(t.size)
                      for i in range(B)]).astype(np.float32)
    ramp = np.linspace(0, 255, size, dtype=np.float32)
    imgs = np.stack([rng.randint(0, 256, (size, size, 3)) if i % 2 else
                     np.broadcast_to(ramp[:, None, None] * (i % 5) / 4,
                                     (size, size, 3))
                     for i in range(B)]).astype(np.uint8)
    return waves, [SERVE_TEXTS[i % 6] for i in range(B)], imgs


def fit_speech_scaler(models_dir, waves):
    """Write speech_scaler.npz fitted to the clips' 56 features, as the
    speech trainer fits it. The synthetic writer's identity scaler feeds
    raw features (up to ~9,000) to the DNN, whose logits then reach ~800:
    a relative rounding of 1e-7 in a batch of another shape moves a
    probability by 5e-5, which says nothing of the split."""
    from mec_tpu_torch.ops import audio_features as af
    feats = af.audio_features_56(torch.from_numpy(waves), 'parity').numpy()
    np.savez(f'{models_dir}/speech_scaler.npz', mean=feats.mean(0),
             scale=feats.std(0) + 1e-6)


def replica_check(dp, one, waves, texts, imgs):
    """(whether each replica's rows of a tri-modal step are bit for bit
    the single-device engine's on the same rows at the same per-replica
    bucket, max |rows - the single engine's whole step|)."""
    n = len(texts)
    b = dp._bucket(n)
    per = b // len(dp.replicas)
    wires = (dp._wire_waves(waves, b), *dp._text_wire(texts, b),
             dp._wire_image(imgs, b))
    got = dp._run('_trimodal_forward', *wires)
    exact = True
    for r in range(len(dp.replicas)):
        part = [tuple(x[r * per:(r + 1) * per] for x in a)
                if isinstance(a, tuple) else a[r * per:(r + 1) * per]
                for a in wires]
        dev = [one._to_device(a) if isinstance(a, tuple)
               else one._to_device((a,))[0] for a in part]
        want = one._trimodal_forward(*dev).cpu().numpy()
        exact = exact and np.array_equal(got[r * per:(r + 1) * per], want)
    whole = one._run_trimodal(waves, texts, imgs)
    return exact, float(np.abs(got[:n] - whole).max())


def _sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_wall_ms(fn, reps=20):
    """Median host-clock milliseconds of fn() (synced on every card)
    after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        _sync_all()
        t0 = time.perf_counter()
        fn()
        _sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_threaded(eng, pool, step, *args):
    """eng._run with each replica's block launched and fetched from its
    own thread of `pool` (the other design of the engine's dispatch,
    timed beside it)."""
    d = len(eng.replicas)
    rows = (args[0][0] if isinstance(args[0], tuple) else args[0]).shape[0]
    per = rows // d

    def one(r):
        rep = eng.replicas[r]
        part = [rep._to_device(x[r * per:(r + 1) * per] for x in a)
                if isinstance(a, tuple)
                else rep._to_device((a[r * per:(r + 1) * per],))[0]
                for a in args]
        with (torch.cuda.device(rep.device) if rep.device.type == 'cuda'
              else contextlib.nullcontext()):
            return getattr(rep, step)(*part).cpu().numpy()

    return np.concatenate(list(pool.map(one, range(d))))


def busy_ms_per_card(fn, reps=5):
    """Each card's device time a call of fn(): the summed durations of its
    kernels in one torch.profiler window of reps calls, over reps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    _sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        _sync_all()
    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.device_index] = (busy.get(e.device_index, 0.0)
                                    + e.time_range.elapsed_us() / 1e3 / reps)
    return busy


def serve_scaling(counts, tiny, card):
    """--serve: the full-width directory on each card count."""
    import tempfile

    from mec_tpu_torch.config import Config
    from mec_tpu_torch.serving.engine import EmotionEngine
    from mec_tpu_torch.serving.synthetic_artifacts import \
        write_synthetic_artifacts
    size = 32 if tiny else 224
    dev = 'cpu' if tiny else 'cuda'
    root = tempfile.TemporaryDirectory(prefix='dp_serve_')
    write_synthetic_artifacts(root.name, tiny=tiny, image_size=size)
    fit_speech_scaler(root.name, serve_inputs(32, size, seed=99)[0])
    saved = Config.COMPUTE_DTYPE, Config.FUSION_MODE
    Config.FUSION_MODE = 'attention'
    try:
        for dtype in ('bfloat16', 'float32'):
            Config.COMPUTE_DTYPE = dtype
            one = EmotionEngine.from_models_dir(root.name, device=dev,
                                                mesh=None)
            for n in counts:
                mesh = ([dev] * n if tiny else
                        [f'cuda:{i}' for i in range(n)])
                eng = (one if n == 1 else EmotionEngine.from_models_dir(
                    root.name, device=dev, mesh=mesh))
                errs, exact = {}, True
                for B in (1, 8, 32):
                    w, t, im = serve_inputs(B, size, seed=B)
                    ok, errs[B] = replica_check(eng, one, w, t, im)
                    exact = exact and ok
                band = 1e-5 if dtype == 'float32' else SERVE_DP_BAND
                if max(errs.values()) > band or (dtype == 'bfloat16'
                                                 and not exact):
                    raise SystemExit(
                        f'serve {n} card(s) {dtype}: rows differ from one '
                        f'card by {errs} (band {band}), replicas exact '
                        f'{exact}')
                line = (f'serve {n} card(s) {dtype}: tri-modal rows against '
                        f'one card max|err| ' + ', '.join(
                            f'B={B} {e:.3e}' for B, e in errs.items())
                        + f' (band {band}); each replica\'s rows bit for bit '
                        f'the single-card step\'s: {exact}')
                if dtype == 'bfloat16':
                    walls, threaded, busy = {}, {}, {}
                    pool = ThreadPoolExecutor(n)
                    for B in (1, 32):
                        w, t, im = serve_inputs(B, size, seed=B)
                        fn = lambda: eng._run_trimodal(w, t, im)  # noqa
                        b = eng._bucket(B)
                        wires = (eng._wire_waves(w, b), *eng._text_wire(t, b),
                                 eng._wire_image(im, b))
                        same = run_threaded(eng, pool, '_trimodal_forward',
                                            *wires)
                        if not np.array_equal(same, eng._run(
                                '_trimodal_forward', *wires)):
                            raise SystemExit('the threaded dispatch differs')
                        # in turns: one thread, a thread a replica, twice
                        for _ in range(2):
                            walls.setdefault(B, []).append(host_wall_ms(fn))
                            threaded.setdefault(B, []).append(host_wall_ms(
                                lambda: run_threaded(  # noqa
                                    eng, pool, '_trimodal_forward',
                                    eng._wire_waves(w, b),
                                    *eng._text_wire(t, b),
                                    eng._wire_image(im, b))[:B]))
                        if not tiny:
                            busy[B] = busy_ms_per_card(fn)
                    pool.shutdown()
                    line += '; host wall a dispatch, one thread ' + ', '.join(
                        f'B={B} ' + ' / '.join(f'{ms:.3f}' for ms in v)
                        + ' ms' for B, v in walls.items())
                    line += '; a thread a replica ' + ', '.join(
                        f'B={B} ' + ' / '.join(f'{ms:.3f}' for ms in v)
                        + ' ms' for B, v in threaded.items())
                    for B, per in busy.items():
                        line += f'; B={B} busy a card ' + ', '.join(
                            f'cuda:{i} {ms:.3f} ms'
                            for i, ms in sorted(per.items()))
                print(f'{line}; {card}', flush=True)
                del eng
            del one
            if not tiny:
                torch.cuda.empty_cache()
    finally:
        Config.COMPUTE_DTYPE, Config.FUSION_MODE = saved
        root.cleanup()


# ----------------------------------------------------------------------
# the BERT trainer's model and pipe axes
# ----------------------------------------------------------------------

def parse_layout(spec):
    """'DxMxP[s][eE]' -> (data, model, pipe, seq_parallel, experts)."""
    import re
    m = re.fullmatch(r'(\d+)x(\d+)x(\d+)(s?)(?:e(\d+))?', spec)
    if m is None:
        raise SystemExit(f'layout {spec!r}: expected DxMxP[s][eE]')
    return (int(m[1]), int(m[2]), int(m[3]), bool(m[4]),
            int(m[5] or 0))


class _NormTx:
    """Wraps a Tx to keep the gradients it is handed and the clip norm."""

    def __init__(self, tx):
        self.tx = tx

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def step(self, grads, state, params, norm_fn=None):
        from mec_tpu_torch.training import common
        self.grads = [g.detach().clone() for g in grads]
        self.norm = float((norm_fn or common.global_norm)(grads))
        self.tx.step(grads, state, params, norm_fn)


def _bert(tiny, experts, dtype, device):
    from mec_tpu_torch.models.bert import BertForSequenceClassification
    from mec_tpu_torch.training import common
    kw = (dict(vocab_size=1000, hidden_size=64, num_layers=4, num_heads=4,
               intermediate_size=128) if tiny else {})
    if experts:
        kw.update(num_experts=experts, moe_capacity_factor=2.0)
    model = common.flax_init(BertForSequenceClassification(**kw,
                                                           dtype=dtype), 0)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model.to(device, dtype)


def _bert_batch(rows, seq, vocab, seed=11):
    rng = np.random.RandomState(seed)
    lengths = np.concatenate([[seq], rng.randint(seq // 4, seq + 1,
                                                 rows - 1)])
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
    return {'ids': rng.randint(5, vocab, (rows, seq)).astype(np.int32) * mask,
            'mask': mask, 'label': rng.randint(0, 7, rows)}


def layout_step(model, batch, mesh, device, microbatches, tx):
    """One training step of the (sharded) model on this rank's rows:
    (loss, the TrainState)."""
    from mec_tpu_torch.parallel import mesh as pmesh
    from mec_tpu_torch.parallel import pipeline
    from mec_tpu_torch.training import common, train_text_bert
    state = common.TrainState(model, tx)
    model.train()
    if mesh is not None and mesh.pipe > 1:
        step = pipeline.make_pipeline_steps(model, mesh, microbatches)[0]
    else:
        step = train_text_bert.make_steps(model)[0]
    with pmesh.data_parallel(mesh):
        loss = step(state, common.to_device(batch, device))
    return loss, state, step


def layout_rank(layouts, tiny, steps, time_it=True, microbatches=4):
    """On each rank of the group: every layout whose rank count is the
    group's, {spec: {'grad_rel', 'loss_err', 'norm_rel', 'ms'}} on global
    rank 0 (None elsewhere)."""
    import torch.distributed as dist

    from mec_tpu_torch.parallel import mesh as pmesh
    from mec_tpu_torch.parallel import partition, pipeline
    from mec_tpu_torch.training import common
    device = (torch.device('cuda', torch.cuda.current_device())
              if torch.cuda.is_available() and not tiny
              else torch.device('cpu'))
    seq = 16 if tiny else 128
    out = {}
    for spec in layouts:
        dp, tp, pp, sp, experts = parse_layout(spec)
        if dp * tp * pp != dist.get_world_size():
            continue
        mesh = pmesh.make_mesh(dp, tp, pp)
        vocab = 1000 if tiny else 30522
        batch = _bert_batch(8 * dp, seq, vocab)
        model = _bert(tiny, experts, torch.float64, device)
        partition.shard_bert(model, mesh, sp)
        pipeline.split_stages(model, mesh)
        tx = _NormTx(common.Tx({'all': common.Adam(1e-3)}))
        loss, state, _step = layout_step(model, mesh.shard_rows(batch),
                                         mesh, device, microbatches, tx)
        full = partition.gather_state(model, dict(zip(state.names,
                                                      tx.grads)))
        loss_t = loss.detach().reshape(1).double()
        mesh.all_reduce_([loss_t], mean=True)
        del model, state
        res = None
        if mesh.global_rank == 0:
            ref_tx = _NormTx(common.Tx({'all': common.Adam(1e-3)}))
            ref_loss, ref_state, _s = layout_step(
                _bert(tiny, experts, torch.float64, device), batch, None,
                device, 0, ref_tx)
            ref = dict(zip(ref_state.names, ref_tx.grads))
            top = max(float(g.abs().max()) for g in ref.values())
            err = max(float((full[k] - g.cpu()).abs().max())
                      for k, g in ref.items())
            if sorted(full) != sorted(ref):
                raise RuntimeError(f'{spec}: gathered names differ')
            res = {'grad_rel': err / top, 'grad_max': top,
                   'loss_err': abs(float(loss_t) - float(ref_loss.detach())),
                   'norm_rel': abs(tx.norm - ref_tx.norm) / ref_tx.norm}
            del ref_state
        if time_it:
            model = _bert(tiny, experts, torch.float32, device)
            partition.shard_bert(model, mesh, sp)
            pipeline.split_stages(model, mesh)
            tx = common.adamw_with_clip(common.cosine_decay_schedule(2e-5,
                                                                     100))
            fbatch = mesh.shard_rows(_bert_batch(16 * dp, seq, vocab))
            _l, state, step = layout_step(model, fbatch, mesh, device,
                                          microbatches, tx)
            dev_batch = common.to_device(fbatch, device)
            with pmesh.data_parallel(mesh):
                ms = _timed(lambda: step(state, dev_batch), steps, device)
            if res is not None:
                res['ms'] = ms
            del model, state
        if device.type == 'cuda':
            torch.cuda.empty_cache()
        out[spec] = res
    return out


def layout_scaling(layouts, tiny, steps, card):
    """--layouts: one group a rank count, every layout of that count."""
    from mec_tpu_torch.parallel import launch
    by_world = {}
    for spec in layouts:
        dp, tp, pp, _sp, _e = parse_layout(spec)
        by_world.setdefault(dp * tp * pp, []).append(spec)
    for n, specs in sorted(by_world.items()):
        devices = launch.devices_for(n, 'cpu' if tiny else 'cuda')
        ranks = launch.launch(layout_rank, n, args=(specs, tiny, steps),
                              devices=devices,
                              threads=1 if tiny else None, timeout=1500)
        for spec in specs:
            dp, tp, pp, sp, experts = parse_layout(spec)
            r = ranks[0][spec]
            if max(r['grad_rel'], r['norm_rel'], r['loss_err']) > 1e-10:
                raise SystemExit(f'layout {spec}: {r}')
            rate = 16 * dp * 1e3 / r['ms']
            print(f'layout data {dp} x model {tp} x pipe {pp}'
                  + (' seq-parallel' if sp else '')
                  + (f' experts {experts}' if experts else '')
                  + (' microbatches 4' if pp > 1 else '')
                  + f': float64 gradients within {r["grad_rel"]:.2e} of the '
                  f'largest ({r["grad_max"]:.2e}), loss within '
                  f'{r["loss_err"]:.2e}, clip norm within {r["norm_rel"]:.2e} '
                  f'relative of one process; fp32 BERT-'
                  f'{"tiny" if tiny else "base"} '
                  f'seq {16 if tiny else 128}, 16 rows a data rank: '
                  f'{r["ms"]:.3f} ms/step, {rate:.1f} samples/s; {card}',
                  flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--ranks', default='1,2,4',
                   help='data-parallel rank counts ("" for none)')
    p.add_argument('--steps', type=int, default=8)
    p.add_argument('--serve', default='',
                   help='card counts to serve on, e.g. 1,2,4')
    p.add_argument('--layouts', default='',
                   help='mesh layouts DxMxP[s][eE], comma-separated')
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
    if args.serve:
        serve_scaling([int(x) for x in args.serve.split(',')],
                      args.device == 'cpu', card)
    if args.layouts:
        layout_scaling(args.layouts.split(','), args.device == 'cpu',
                       args.steps, card)
    base = None
    for n in (int(x) for x in args.ranks.split(',') if x):
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
