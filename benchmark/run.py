"""One run of one benchmark cell of mec_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json) names a configuration (benchmark/configs/) and
a traffic mix (benchmark/traffic/). Set-up pins the configuration's
environment, draws the weights and the traffic's pools from the seed,
builds the port's EmotionEngine (mesh=None) and EngineBatcher as the
port builds them, warms the cell's buckets and sends a few untimed
requests. The window then drives tri-modal requests for --seconds:
predecode_multimodal in the request's thread, then
EngineBatcher.multimodal.submit. After it closes: the memory peak, the
metrics (--trace 0: the cell's end-to-end metrics; --trace 1: its
per-layer metrics from spans, counters and a profiled sub-window), then
the output check against the float32 reference in benchmark/reference/,
run once the program's state is freed. The last line of standard output
is the result; the compared numbers and their limits are the last lines
of standard error and the result's last key.

Exits non-zero with no result where no CUDA card (or fewer than the cell
asks for) is visible, and where jax, jaxlib, flax or mec_tpu was imported.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import check, drive, hostload, stats, trace  # noqa: E402
from benchmark.harness import traffic as tr  # noqa: E402
from benchmark.harness.cells import Cell, leg  # noqa: E402
from benchmark.harness.peaks import PEAKS  # noqa: E402
from benchmark.harness.vocab import build_vocab  # noqa: E402
from benchmark.reference import wordpiece  # noqa: E402
from benchmark.weights.trees import make_trees  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mec_tpu')
pc = time.perf_counter


def process_age() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open('/proc/self/stat') as f:
        start = float(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf('SC_CLK_TCK')


T_PROC = pc() - process_age()


# a crash in native code names the Python line it came from on stderr
faulthandler.enable()


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(names=None):
    """The loaded modules (or `names`) whose top-level name, compared
    whole, is jax, jaxlib, flax or mec_tpu: mec_tpu_torch is not."""
    names = sys.modules if names is None else names
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def pin_environment(cell) -> None:
    os.environ.update({k: str(v) for k, v in cell.config['env'].items()})
    cache = os.path.join(HERE, '_cache')
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'nv')):
        os.environ[var] = os.path.join(cache, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def build_engine(cfg, trees, vocab, device):
    from mec_tpu_torch.serving.batcher import EngineBatcher
    from mec_tpu_torch.serving.engine import EmotionEngine
    f = cfg['fusion']
    kw = dict(image_variables=trees['image'], image_meta=trees['image_meta'],
              **leg(cfg, 'text').engine_kwargs(cfg['text'], trees['text'],
                                               vocab))
    if f['kind'] == 'attention':
        kw.update(fusion_variables=trees['fusion'],
                  fusion_config={k: f[k] for k in (
                      'speech_dim', 'text_dim', 'image_dim', 'hidden_dim',
                      'num_classes')})
    else:
        kw.update(forest_arrays=trees['forest'],
                  forest_meta=trees['forest_meta'])
    sc = cfg['speech_scaler']
    engine = EmotionEngine(trees['speech'],
                           (np.asarray(sc['mean'], np.float32),
                            np.asarray(sc['scale'], np.float32)),
                           device=device, mesh=None, **kw)
    return engine, EngineBatcher(engine)


class Context(SimpleNamespace):
    """What the metric readers read."""

    def ok(self, rec) -> bool:
        return rec.answer is not None and self.served(rec.answer)

    def tokens(self, rec) -> int:
        if rec.req.index not in self._tok:
            ids, mask = self.wordpiece.encode([rec.req.text], self.vocab,
                                              self.max_len)
            self._tok[rec.req.index] = int(mask.sum())
        return self._tok[rec.req.index]

    def kernel_of(self, name: str):
        for mod in self.bounds.values():
            if any(g in name for g in mod.GLOBALS):
                return mod
        return None


CHILD = 'MEC_BENCH_TRACED_CHILD'
RETRY = 'MEC_BENCH_TRACED_RETRY'


def traced_in_child(cmd, env=None) -> int:
    """Run a traced run in a child process, which prints the result
    itself, and run it once more if a signal killed it. torch.profiler
    crashes the process now and then while it records or as it stops
    (glibc 'double free or corruption' or 'free(): invalid pointer',
    SIGABRT or SIGSEGV, in a thread that runs no Python): with the
    port's hand-written kernels switched off, and with its native host
    libraries absent, too, and in no untraced run (PERF.md, section 7).
    The rerun's result names the signal under 'traced_retry'; a rerun
    that dies as well exits non-zero with no result."""
    env = dict(os.environ if env is None else env, **{CHILD: '1'})
    rc = subprocess.run(cmd, env=env).returncode
    if rc >= 0:
        return rc
    log(f'the traced run died of signal {-rc} in the profiler; '
        f'running it once more')
    env[RETRY] = str(-rc)
    rc = subprocess.run(cmd, env=env).returncode
    return rc if rc >= 0 else 1


def main(argv=None, device: str = 'cuda', fault=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    cfg, mix = cell.config, cell.mix
    pin_environment(cell)

    chips = cell.entry['chips']
    if device == 'cuda' and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        log(f'{args.workload} needs {chips} CUDA device(s); '
            f'torch.cuda.is_available()={torch.cuda.is_available()}, '
            f'device_count={torch.cuda.device_count()}')
        return 2
    if args.trace and device == 'cuda' and not os.environ.get(CHILD):
        return traced_in_child([sys.executable, os.path.abspath(__file__)]
                               + list(sys.argv[1:] if argv is None
                                      else argv))
    dev = torch.device(device)

    workdir = tempfile.mkdtemp(prefix='mec-bench-')
    try:
        return _run(args, cell, cfg, mix, dev, workdir, fault)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(args, cell, cfg, mix, dev, workdir, fault) -> int:
    cuda = dev.type == 'cuda'
    if cuda:
        torch.zeros(1, device=dev)     # the card's context, in set-up
    # the traffic's pools and texts and the vocabulary are the
    # benchmark's own inputs, not the deployment's set-up: not in setup_s
    t_gen = pc()
    vocab, words = build_vocab(cfg['text']['vocab_size'])
    traffic = tr.build(mix, args.seed, args.seconds, words, workdir, dev)
    gen_s = pc() - t_gen
    trees = make_trees(cfg, args.seed, dev)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    from mec_tpu_torch.utils.profiling import timer as stage_timer
    engine, batcher = build_engine(cfg, trees, vocab, dev)
    del trees
    engine.warmup(tuple(mix['warmup_buckets']))
    if fault is not None:
        fault(engine)
    spans = drive.Spans() if args.trace else None
    if spans is not None:
        drive.install(engine, spans)
    call = drive.request_fn(engine, batcher, spans)
    # the untimed warm-up requests: one alone, then all at once
    warm = traffic.warmup
    drive._do(call, drive.Record(warm[0]))
    w = drive.ClosedLoop(call, warm[1:], len(warm) - 1, pc() + 0.001)
    w.finish(pc() + 120)
    counters = {}
    if args.trace:
        import importlib
        if cuda:
            trace.warm_profiler()
        for name, mod in cell.bounds().items():
            m, attr = mod.COUNTER
            counters[name] = getattr(importlib.import_module(m), attr)
    if cuda:
        torch.cuda.synchronize()

    # ---------------------------------------------------------- window
    stage_timer.reset()
    s0 = batcher.stats()['multimodal']
    gcc = hostload.GcClock()
    gcc.start()
    cpu0 = hostload.cpu_seconds()
    t0 = pc()
    setup_s = t0 - T_PROC - gen_s
    t1 = t0 + args.seconds
    if mix['loop'] == 'open':
        loop = drive.OpenLoop(call, traffic.timed, t0, mix['workers'])
    else:
        loop = drive.ClosedLoop(call, traffic.timed, mix['clients'], t1)
    sub = None
    if args.trace and cuda:
        # the profiled sub-window is the window's last trace_seconds; the
        # profiler stops, and its trace is read, after the drain, so that
        # neither falls into the window
        time.sleep(max(0.0, t1 - mix['trace_seconds'] - pc()))
        sub = trace.SubWindow(workdir)
        sub.start()
        c0 = {k: v.launches for k, v in counters.items()}
    time.sleep(max(0.0, t1 - pc()))
    cpu_used = hostload.cpu_seconds() - cpu0
    gc_line = gcc.stop()
    if sub is not None:
        sub.mark()
        c1 = {k: v.launches for k, v in counters.items()}
    s1 = batcher.stats()['multimodal']
    loop.finish(pc() + mix['drain_seconds'])
    t_closed = pc()
    reading = sub.stop() if sub is not None else None
    timer_summary = stage_timer.summary()
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    kind = cfg['fusion']['kind']
    records = loop.records
    served = [r for r in records if r.answer is not None
              and check.served(r.answer, kind)]
    ok_ids = {id(r) for r in served}
    failed = [r for r in records if id(r) not in ok_ids]
    ctx = Context(
        setup_s=setup_s, window=(t0, t1), records=records,
        served=lambda a: check.served(a, kind), spans=spans or drive.Spans(),
        timer=timer_summary,
        stats={'batches': s1['batches'] - s0['batches'],
               'items': s1['items'] - s0['items']},
        trace=reading, peaks=PEAKS, bounds=cell.bounds(),
        flops=cell.flops(), wordpiece=wordpiece, vocab=vocab,
        max_len=cfg['text']['max_length'], _tok={})
    ctx.done = [r for r in served if t0 <= r.t_done <= t1]
    if mix['loop'] == 'open':
        ctx.latencies_ms = [(r.t_done - r.due) * 1e3 if id(r) in ok_ids
                            else float('inf') for r in records]
        late = [r.t_send - r.due for r in records if r.t_send is not None]
        log(f'open loop: {len(records)} due at {mix["rate_per_s"]} req/s, '
            f'{len(served)} answered; generator lateness median '
            f'{statistics.median(late) * 1e3:.3f} ms, max '
            f'{max(late) * 1e3:.3f} ms; answered by the close '
            f'{sum(1 for r in served if r.t_done <= t1)}')
    else:
        # every request sent inside the window, from its send to its answer
        ctx.latencies_ms = [(r.t_done - r.t_send) * 1e3 if id(r) in ok_ids
                            else float('inf') for r in records
                            if r.t_send is not None and r.t_send <= t1]
        log(f'closed loop: {mix["clients"]} clients, {len(records)} sent, '
            f'{len(ctx.done)} answered inside the window')
    if served:
        lat = [(r.t_done - (r.due or r.t_send)) * 1e3 for r in served]
        log(f'latency ms (answered): p50 {stats.percentile(lat, 50):.3f} '
            f'p95 {stats.percentile(lat, 95):.3f} max {max(lat):.3f}')
    log(f'batcher: {ctx.stats["items"]} items in {ctx.stats["batches"]} '
        f'dispatches across the window')
    log(f'this process used {cpu_used / args.seconds:.3f} CPUs over the '
        f'window; ' + gc_line)
    log(hostload.slices(records, t0, t1))
    log('stage medians ms: ' + ', '.join(
        f'{k} {v["p50_ms"]:.3f} (n {v["count"]})'
        for k, v in sorted(timer_summary.items())))
    if spans is not None:
        sizes = [s[4] for s in spans.within('dispatch', t0, t1)]
        hist = {n: sizes.count(n) for n in sorted(set(sizes))}
        log(f'dispatch sizes (requests: dispatches): {hist}')
    for r in failed[:5]:
        log(f'failed request {r.req.index}: {r.error or r.answer}')

    metrics = {}
    if args.trace:
        wanted, kindname = cell.per_layer(), 'layer_metrics'
    else:
        wanted, kindname = cell.end_to_end(), 'end_to_end'
    for m in wanted:
        v = cell.reader(m['name'], kindname).read(ctx)
        if v is not None:
            metrics[m['name']] = {'value': float(v), 'unit': m['unit']}
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': torch.cuda.get_device_name(dev) if cuda
                   else 'cpu', 'count': cell.entry['chips'],
                   'memory_peak_bytes': int(mem_peak)}
    result = {'correct': False, 'attempted': len(records),
              'failed': len(failed), 'metrics': metrics,
              'device': device_info}
    if reading is not None:
        device_info.update(busy_s=reading.busy_s, window_s=reading.window_s)
        result['breakdown'] = breakdown(reading, spans, ctx)
        for name, fn in counters.items():
            mod = ctx.bounds[name]
            seen = sum(1 for la in reading.launches
                       if any(g in la.name for g in mod.GLOBALS))
            log(f'trace check {name}: {seen} device launches in the '
                f'sub-window, the wrapper counted {c1[name] - c0[name]} '
                f'calls x {mod.LAUNCHES}; {reading.events} trace events')

    # ----------------------------------------------------- output check
    batcher.stop()
    del engine, batcher, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rng = tr._stream(args.seed, 3)
    answered = [r for r in records if r.answer is not None]
    longest = max(range(len(answered)),
                  key=lambda i: answered[i].req.n_words) if answered else None
    idx = check.sample(len(answered), mix['check_requests'], rng,
                       [] if longest is None else [longest])
    picked = [answered[i] for i in idx]
    limits = cfg['check']
    numbers = {}
    if picked and all(check.served(r.answer, kind) for r in picked):
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        from benchmark.reference.pipeline import Reference
        ref = Reference(cfg, make_trees(cfg, args.seed, dev), vocab, dev)
        t_ref = pc()
        answers = [r.answer for r in picked]
        expect = ref.run([r.req for r in picked], answers)
        numbers = check.gaps(answers, expect)
        log(f'reference: {len(picked)} requests in {pc() - t_ref:.1f} s; '
            f'all gaps {json.dumps(numbers)}')
    found = forbidden_modules()
    if found:
        log(f'imported and not allowed on the card: {", ".join(found)}')
        return 3
    if os.environ.get(RETRY):
        result['traced_retry'] = {'after_signal': int(os.environ[RETRY])}
    result['correct'] = bool(
        numbers and not failed and len(records) > 0
        and all(numbers[k] <= limits[k] for k in limits))
    result['check'] = {k: {'value': numbers.get(k), 'limit': limits[k]}
                       for k in limits}
    result['check']['failed'] = {'value': len(failed), 'limit': 0}
    if cuda:
        try:
            card = subprocess.run(
                ['nvidia-smi', '--query-gpu=name,power.limit',
                 '--format=csv,noheader'], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            card = f'nvidia-smi: {e}'
        log(f'card: {card}')
    log(f'window {args.seconds} s closed {t_closed - t1:.2f} s after its end;'
        f' setup {setup_s:.2f} s (the traffic and vocabulary, '
        f'{gen_s:.2f} s, apart); memory peak {mem_peak} B')
    for k, v in result['check'].items():
        log(f'check {k}: {v["value"]} (limit {v["limit"]})')
    print(json.dumps(result), flush=True)
    return 0


def breakdown(reading, spans, ctx):
    """The ten device operations with the most time, and the device's idle
    time by what the host was doing: inside a step's _run (launching
    or fetching), a dispatch's host work, a request's decode, or none of
    these (the batcher waiting for requests or for a slot)."""
    def covered(name, t):
        return any(s[2] <= t <= s[3] for s in spans.data.get(name, ()))

    idle = {}
    for a, b in reading.gaps:
        mid = (a + b) / 2
        label = next((lab for name, lab in (
            ('step', 'host:step_launch_or_fetch'),
            ('dispatch', 'host:dispatch_work'),
            ('decode', 'host:request_decode')) if covered(name, mid)),
            'host:no_dispatch_in_flight')
        idle[label] = idle.get(label, 0.0) + (b - a)
    return {'device_ops': [[n, s] for n, s in reading.ops[:10]],
            'idle_gaps': sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


if __name__ == '__main__':
    sys.exit(main())
