#!/usr/bin/env python3
"""Smoke test of mec_tpu_torch's speech serving path on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (the first failure exits non-zero; no phase's failure is caught):
  1. device   require a CUDA device; print nvidia-smi's name, power.limit
  2. build    build the CUDA kernels from mec_tpu_torch/csrc (nvcc, sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the serving path's shapes for B=32 and B=1, on seeded
              tones, chirps, noise and one silent clip
  4. engine   full-width speech DNN from a numpy seed (Flax layout,
              serving/synthetic_artifacts.py; the plain model's copy
              converted with speech_state_from_jax); the engine warms up
              buckets (1, 8, 32), predicts B=1, 5, 32 and serves 4 WAV
              files through the micro-batcher; checks results, the launch
              counters (each kernel once per dispatch) and agreement with
              the same engine on device='cpu'
  5. times    CUDA-event medians of each kernel and its plain version at
              B=32, and of the engine's device step at B=1, 8, 32
  6. report   a JSON line of the kernels, then the contract line last:
              {"ok": true, "device": {"platform": "gpu", ...}}
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N = 66150
REPS = 30


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def waves(B, seed):
    """Seeded test clips: silence (row 0), tones, chirps, noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 22050.0
    rows = [np.zeros(N)]
    for i in range(1, B):
        kind = i % 3
        if kind == 0:
            y = 0.3 * np.sin(2 * np.pi * (150 + 37 * i) * t) \
                + 0.1 * np.sin(2 * np.pi * (310 + 71 * i) * t)
        elif kind == 1:
            y = 0.2 * np.sin(2 * np.pi * (200 + 300 * t * i) * t)
        else:
            y = 0.02 * i * rng.randn(N)
        rows.append(y + 0.01 * rng.randn(N))
    return np.stack(rows).astype(np.float32)


def cuda_ms(fn, reps=REPS):
    """Median milliseconds of fn() over reps runs, each bracketed by CUDA
    events on the current stream, after 3 warm-up runs."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def main():
    if not os.path.isdir(os.path.join(HERE, 'mec_tpu_torch')):
        fail('mec_tpu_torch/ is not beside chip_smoke.py: run it from a '
             'checkout of the repository')
    sys.path.insert(0, HERE)
    import torch

    # ---------------------------------------------------------- 1 device
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this needs an NVIDIA GPU')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    print(f'device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}'
          f' | CUDA {torch.version.cuda}')

    # ----------------------------------------------------------- 2 build
    import mec_tpu_torch  # noqa: F401  (TF32 off)
    from mec_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f'build: {time.perf_counter() - t0:.2f} s (nvcc '
          f'{_build.build_info["seconds"]:.2f} s)')
    for line in _build.build_info['log'].splitlines():
        if 'registers' in line or 'Compiling entry' in line:
            print('  ptxas:', line.strip().split('ptxas info    : ')[-1])

    from mec_tpu_torch.ops import audio_features as af
    from mec_tpu_torch.ops import rolloff_kernel, speech_kernels, tuning_kernel
    from mec_tpu_torch.serving.synthetic_artifacts import speech_variables
    wrappers = {'mfcc_mean': speech_kernels.mfcc_mean,
                'tuning_select': tuning_kernel.tuning_select,
                'rolloff_bins': rolloff_kernel.rolloff_bins,
                'speech_dnn': speech_kernels.speech_dnn}

    # --------------------------------------------------------- 3 kernels
    tree = speech_variables(seed=2)
    errs = {}
    inputs32 = None
    for B in (32, 1):
        y = torch.from_numpy(waves(32, seed=0)[-B:] if B == 1
                             else waves(B, seed=0)).to(dev)
        mag, P = af.hop_spectrograms(y)
        mags, pitches = af.tuning_candidates(P)
        residual = af.fold_residual(pitches)
        rows = mag.reshape(-1, mag.shape[-1])
        feats = af.audio_features_56(y)
        if B == 32:
            mean = feats.mean(dim=0)
            scale = feats.std(dim=0) + 1e-3
            fwd = speech_kernels.make_speech_dnn(tree, dev)
        x = ((feats - mean) / scale).contiguous()
        if B == 32:
            inputs32 = (P, mags, residual, pitches, rows, x)

        # K1: differs from the plain version only in summation order (and
        # log10f's last bit); MFCC0 of the silent clip is -1131, where
        # one f32 ulp is 1.2e-4: |k - p| <= 1e-4 + 2e-6 |p|
        k, p = speech_kernels.mfcc_mean(P), speech_kernels.mfcc_mean_plain(P)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        ratio = ((k - p).abs() / (1e-4 + 2e-6 * p.abs())).max().item()
        check(ratio <= 1.0,
              f'mfcc_mean B={B}: |err| up to {ratio:.2f}x 1e-4 + 2e-6|p|')
        errs['mfcc_mean'] = max(errs.get('mfcc_mean', 0.0), err)
        print(f'kernel mfcc_mean     B={B:2d}: max|err| {err:.3e}, worst '
              f'|err| / (1e-4 + 2e-6|p|) = {ratio:.3f} (<= 1)')

        # K2: integer and compare work only -> bit-exact
        kb, kh = tuning_kernel.tuning_select(mags, residual, pitches)
        pb, ph = tuning_kernel.tuning_select_plain(mags, residual, pitches)
        torch.cuda.synchronize()
        check(torch.equal(kb, pb) and torch.equal(kh, ph),
              f'tuning_select B={B}: not bit-exact ({kb.tolist()} vs '
              f'{pb.tolist()}, {kh.tolist()} vs {ph.tolist()})')
        errs['tuning_select'] = 0.0
        print(f'kernel tuning_select B={B:2d}: best bins and has_any equal '
              f'(bit-exact), {int(kh.sum())}/{B} clips with candidates')

        # K3: bins equal, except a one-bin step where the crossing is a
        # near-tie: the f64 prefix at the lower bin within F * 2**-24 of
        # the f64 threshold, relative to the row total (the worst-case
        # rounding of an f32 sum of F = 1025 terms)
        kbin = rolloff_kernel.rolloff_bins(rows)
        pbin = rolloff_kernel.rolloff_bins_plain(rows)
        torch.cuda.synchronize()
        diff = (kbin - pbin).abs()
        bad = torch.nonzero(diff).flatten().tolist()
        for r in bad:
            cum = torch.cumsum(rows[r].double(), 0)
            lo_bin = min(kbin[r].item(), pbin[r].item())
            tie = abs(cum[lo_bin].item() - 0.85 * cum[-1].item())
            check(diff[r].item() == 1
                  and tie <= rows.shape[1] * 2.0 ** -24 * cum[-1].item(),
                  f'rolloff_bins B={B} row {r}: kernel {kbin[r].item()} vs '
                  f'plain {pbin[r].item()} is not a near-tie')
        errs['rolloff_bins'] = max(errs.get('rolloff_bins', 0.0),
                                   float(diff.max().item()))
        print(f'kernel rolloff_bins  B={B:2d}: {len(bad)} of {rows.shape[0]} '
              f'rows differ, each a one-bin near-tie')

        # K4: fp32 FMAs in another order than cuBLAS; the JAX kernel
        # test's bounds: probs 2e-6, penult 2e-5, zeros past column 71
        k = fwd(x)
        p = speech_kernels.speech_dnn_plain(x, fwd.params, fwd.dims)
        torch.cuda.synchronize()
        e_prob = (k[:, :7] - p[:, :7]).abs().max().item()
        e_pen = (k[:, 7:] - p[:, 7:]).abs().max().item()
        check(e_prob <= 2e-6 and e_pen <= 2e-5,
              f'speech_dnn B={B}: probs err {e_prob}, penult err {e_pen}')
        check(bool((k[:, 71:] == 0).all()), 'speech_dnn: columns 71+ not 0')
        errs['speech_dnn'] = max(errs.get('speech_dnn', 0.0), e_prob, e_pen)
        print(f'kernel speech_dnn    B={B:2d}: probs max|err| {e_prob:.3e} '
              f'(<= 2e-6), penult {e_pen:.3e} (<= 2e-5)')

    # ---------------------------------------------------------- 4 engine
    from mec_tpu_torch.convert.from_jax import speech_state_from_jax
    from mec_tpu_torch.models.speech_dnn import SpeechDNN
    from mec_tpu_torch.ops import wav
    from mec_tpu_torch.serving import wire
    from mec_tpu_torch.serving.batcher import EngineBatcher
    from mec_tpu_torch.serving.engine import EmotionEngine

    scaler = (mean.cpu().numpy(), scale.cpu().numpy())
    engine = EmotionEngine(tree, scaler, device='cuda')
    cpu_engine = EmotionEngine(tree, scaler, device='cpu')
    model = SpeechDNN().to(dev).eval()
    model.load_state_dict(speech_state_from_jax(tree))
    clips = waves(32, seed=1)
    tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_')
    paths = []
    for i in range(4):
        paths.append(os.path.join(tmp.name, f'clip{i}.wav'))
        wav.write_wav(paths[-1], clips[i + 1], 22050)

    for w in wrappers.values():
        w.launches = 0
    engine.warmup((1, 8, 32))
    results = {B: engine.predict_speech_waves(clips[:B], want_features=True)
               for B in (1, 5, 32)}
    batcher = EngineBatcher(engine)
    served = [None] * len(paths)
    try:
        threads = [threading.Thread(
            target=lambda i=i: served.__setitem__(
                i, batcher.speech.submit(paths[i])))
            for i in range(len(paths))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        check(not any(th.is_alive() for th in threads),
              'batcher requests did not finish')
    finally:
        batcher.stop()
    launches = {name: w.launches for name, w in wrappers.items()}
    dispatches = 3 + 3 + batcher.stats()['speech']['batches']
    print(f'engine: {dispatches} speech dispatches (3 warmup, 3 direct, '
          f'{dispatches - 6} batcher); launches {launches}')
    for name, n in launches.items():
        check(n == dispatches, f'{name} launched {n} times in '
              f'{dispatches} dispatches (want exactly one per dispatch)')

    served_ref = cpu_engine.predict_speech_paths(paths)
    checks = [(results[B], cpu_engine.predict_speech_waves(
        clips[:B], want_features=True)) for B in (1, 5, 32)]
    checks.append((served, served_ref))
    worst = 0.0
    for got, ref in checks:
        check(len(got) == len(ref), 'result count mismatch')
        for g, r in zip(got, ref):
            check(g is not None and '_fallback' not in g, f'fallback: {g}')
            check(abs(sum(g['all_probabilities']) - 1.0) <= 1e-5,
                  f'probabilities sum to {sum(g["all_probabilities"])}')
            check(g['emotion'] == r['emotion'],
                  f'decision {g["emotion"]} vs cpu {r["emotion"]}')
            e = float(np.max(np.abs(np.subtract(g['all_probabilities'],
                                                r['all_probabilities']))))
            worst = max(worst, e)
            check(e <= 1e-4, f'probs differ from cpu by {e}')
    # the plain unfolded model on the card, on the samples the 12-bit
    # wire delivers: the same answer
    packed, pcm_scale = wire.encode_pcm12_np(clips)
    with torch.no_grad():
        feats = af.audio_features_56(wire.decode_pcm12(
            torch.from_numpy(packed).to(dev),
            torch.from_numpy(pcm_scale).to(dev)))
        m_probs, m_pen = model((feats - mean) / scale)
    got_probs = np.array([r['all_probabilities'] for r in results[32]])
    got_pen = np.stack([r['_features'] for r in results[32]])
    e_model = max(np.abs(got_probs - m_probs.cpu().numpy()).max(),
                  np.abs(got_pen - m_pen.cpu().numpy()).max())
    check(e_model <= 1e-4, f'engine vs plain SpeechDNN: {e_model}')
    labels = sorted({r['emotion'] for r in results[32]})
    print(f'engine: results agree with device=cpu (max probs err {worst:.2e}'
          f' <= 1e-4) and with the plain SpeechDNN ({e_model:.2e}); '
          f'no fallbacks; decisions at B=32: {labels}')
    tmp.cleanup()

    # ----------------------------------------------------------- 5 times
    P, mags, residual, pitches, rows, x = inputs32
    timed = {
        'mfcc_mean': (lambda: speech_kernels.mfcc_mean(P),
                      lambda: speech_kernels.mfcc_mean_plain(P)),
        'tuning_select': (
            lambda: tuning_kernel.tuning_select(mags, residual, pitches),
            lambda: tuning_kernel.tuning_select_plain(mags, residual,
                                                      pitches)),
        'rolloff_bins': (lambda: rolloff_kernel.rolloff_bins(rows),
                         lambda: rolloff_kernel.rolloff_bins_plain(rows)),
        'speech_dnn': (lambda: fwd(x),
                       lambda: speech_kernels.speech_dnn_plain(
                           x, fwd.params, fwd.dims)),
    }
    times = {}
    for name, (kern, plain) in timed.items():
        # alternate plain, kernel, kernel, plain so drift hits both
        p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kern, kern, plain))
        times[name] = (statistics.median([k1, k2]),
                       statistics.median([p1, p2]))
        print(f'time {name:13s} B=32: kernel {times[name][0]:.4f} ms, plain '
              f'{times[name][1]:.4f} ms (median of {REPS} CUDA-event runs; '
              f'{card})')
    for B in (1, 8, 32):
        wire_dev = engine._to_device(engine._wire_waves(clips[:B], B))
        step = cuda_ms(lambda: engine._speech_forward(wire_dev))
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine._run_speech(clips[:B])
            host.append((time.perf_counter() - t0) * 1e3)
        print(f'time engine device step B={B:2d}: {step:.4f} ms (CUDA '
              f'events, wire already on the card); _run_speech host wall '
              f'{statistics.median(host):.2f} ms (median of 10, incl. pcm12 '
              f'encode + copies); {card}')

    # ---------------------------------------------------------- 6 report
    sources = {'mfcc_mean': ('mec_tpu_torch/csrc/mfcc_mean.cu',
                             'mec_tpu/ops/pallas_kernels.py:211'),
               'tuning_select': ('mec_tpu_torch/csrc/tuning_select.cu',
                                 'mec_tpu/ops/pallas_tuning.py:116'),
               'rolloff_bins': ('mec_tpu_torch/csrc/rolloff_bins.cu',
                                'mec_tpu/ops/pallas_rolloff.py:71'),
               'speech_dnn': ('mec_tpu_torch/csrc/speech_dnn.cu',
                              'mec_tpu/ops/pallas_kernels.py:286')}
    print(card)
    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda', 'source': sources[name][0],
         'replaces': sources[name][1], 'launches': launches[name],
         'max_abs_err': errs[name], 'ms': times[name][0],
         'plain_ms': times[name][1]} for name in wrappers]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
