#!/usr/bin/env python3
"""K1 (mfcc_mean), K2 (tuning_select), K3 (rolloff_bins), K4
(speech_dnn), K5 (dft_power) and K7 (layer1_int8) on one NVIDIA GPU:
build report, checks against the plain versions, and times, optionally
in turns with an older build of the sources.

    python3 -m mec_tpu_torch.bench.kernel_ab [--kernels k1,k2,k3,k4,k5,k7]
        [--old-csrc DIR] [--reps N] [--profile] [--split] [--variants]
        [--trace] [--bert-drift] [--mobilenet-drift]

* build: what ptxas reports for the sources (registers, spills, shared
  memory) and, where the toolkit has cuobjdump, how many tensor-core
  instructions the built library holds per kernel (HMMA for K5 'bf16',
  IMMA for K7's convs) and, for the two cluster kernels K1 and K4, their
  cluster barriers (UCGABAR) and cp.async copies (LDGSTS).
* check, K1: B in {1, 2, 8, 32, 33} with the silent clip and a clip of
  one loud frame in the batch, |k - p| <= 1e-4 + 2e-6|p| against the
  plain version, two runs torch.equal, and both against the same
  algebra in fp64. K4: B in {1, 8, 9, 32, 33,
  64} at full width and with a narrow network (56-32-16-7): probs 2e-6,
  penult 2e-5, zeros past the packed values.
* check, K2: B in {1, 8, 32, 33} of silence, tones, chirps and noise, a
  noise-only batch, the silent clip alone, and made-up rows in which
  every slot is a candidate (with and without tied magnitudes):
  torch.equal against the plain version, and two runs torch.equal. K3:
  B in {1, 8, 32, 33} and an all-zero row: bins equal to the plain
  version's except one-bin steps at near-ties (the f64 prefix within
  F * 2**-24 of the threshold).
* check: K5 at B*T in {1, 130, 131, 4160} in both precisions against the
  plain version (mag atol 5e-5, P relative 5e-3, the JAX package's
  contract) and, for reference, both against fp64 sums of the same
  operands;
  K7 torch.equal against the plain version at B in {1, 2, 32} and an odd
  map.
* time: CUDA-event medians at B = 32 (and B = 1; K1 to K4 also B = 8).
  With --old-csrc, a directory that holds earlier sources (for example
  `git show <commit>:mec_tpu_torch/csrc/dft_power.cu`), those found
  there are built into libraries of their own and timed in turns old,
  new, new, old. An older dft_power.cu and layer1_int8.cu must have the
  interface of the first version of these kernels (one fp32 table
  layout for K5; six scratch maps for K7); an older mfcc_mean.cu and
  speech_dnn.cu the one-block-a-clip and 8-row-tile interface (dense
  mel table with lo/hi runs; dims, n_layers, B); an older
  tuning_select.cu and rolloff_bins.cu the one-block-a-clip and
  two-pass interface (no cluster size, no rows a block). --profile adds the
  device time of each launch (torch.profiler), for the old K1 and K4
  too. --variants times K4 at cluster sizes 8 and 16 (at 8 a 512-wide
  layer's slice outgrows its shared-memory slot and takes the scalar
  path), K1 at 5, 10 and 13 blocks a clip, K2 at 1, 2, 4 and 8 blocks
  a clip and K3 at 1, 2, 4 and 8 rows a block, through the C interface.
* --bert-drift (alone; no kernel is built): where the int8-static BERT
  on the card leaves the same model on the CPU (full-width synthetic
  BERT-base, the card's static scales on both). Free run: after the
  embeddings and each of the 12 layers the largest difference of the
  hidden state, and for every QuantDense of a layer whether its int8
  operand (the quantized activation that torch._int_mm takes) is
  bit-equal on both devices, and if not, how many codes differ. Same
  input: each stage of each layer computed on the card from the CPU
  run's operands, which names the operations whose results differ
  between the devices on identical inputs.
* --mobilenet-drift (alone, or with --bert-drift): the same for the
  int8-static MobileNetV2 at 224 px (chip_smoke.py's models-directory
  image model), at B = 1 and 4: the stem's output, then block by block
  in the free run, and each stage of each block (expand QuantConv,
  ReLU6, depthwise conv, ReLU6, project QuantConv, residual) on the CPU
  run's operands.

* --trace: K1, K2 and K4 built alone with -DMEC_TRACE (csrc/trace.cuh): the
  clocks one block spends between the phase marks of its source, at
  B = 1 and 32 (thread 0 of block 0, clock64; the fifth launch).

Exits non-zero on the first failed check. Needs a CUDA device.
"""

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import mec_tpu_torch  # noqa: F401  (TF32 off)
from mec_tpu_torch.convert.from_jax import image_state_from_jax
from mec_tpu_torch.models.resnet import Bottleneck
from mec_tpu_torch.ops import _build, dft_kernel, resnet_kernel
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import rolloff_kernel as rk
from mec_tpu_torch.ops import speech_kernels as sk
from mec_tpu_torch.ops import tuning_kernel as tk
from mec_tpu_torch.serving.synthetic_artifacts import (layer1_quant_params,
                                                       speech_variables)

MAG_ATOL, P_REL = 5e-5, 5e-3


def cuda_ms(fn, reps):
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


def frames_of(m, dev, seed=0):
    """(1, m, 2048) Hann-windowed 0.1-scale noise frames."""
    x = np.random.RandomState(seed).randn(1, m, 2048).astype(np.float32) * 0.1
    hann = np.hanning(2049)[:2048].astype(np.float32)
    return torch.from_numpy(x * hann).to(dev)


def layer1_blocks(dev, seed=0):
    state = image_state_from_jax({'params': layer1_quant_params(seed)})
    blocks = []
    for b in range(3):
        blk = Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0,
                         dtype=torch.bfloat16, fold_bn=True, quant=True,
                         quant_mode='static')
        blk.load_state_dict({k.split('.', 1)[1]: v for k, v in state.items()
                             if k.startswith(f'layer1_{b}.')})
        blocks.append(blk.to(dev))
    return blocks


SOURCES = {'k1': 'mfcc_mean.cu', 'k2': 'tuning_select.cu',
           'k3': 'rolloff_bins.cu', 'k4': 'speech_dnn.cu',
           'k5': 'dft_power.cu', 'k7': 'layer1_int8.cu'}


def build_report(kernels):
    _build.library()
    log = _build.build_info['log']
    lib_path = _build.build()     # the hashed library now exists: its path
    keep = False
    for line in log.splitlines():
        if line.startswith('--- '):
            keep = line.split()[1] in [SOURCES[k] for k in kernels]
        if keep and ('registers' in line or 'spill' in line
                     or 'Compiling entry' in line):
            print('ptxas:', line.strip().split('ptxas info    : ')[-1])
    cuobjdump = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not Path(cuobjdump).exists():
        print('sass: no cuobjdump in this toolkit')
        return
    sass = subprocess.run([cuobjdump, '-sass', str(lib_path)],
                          capture_output=True, text=True).stdout
    name, counts = None, {}
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split('Function :')[1].strip()
        for op in ('HMMA', 'IMMA', 'HGMMA', 'IGMMA', 'IDP.4A', 'IDP4A',
                   'LDGSTS', 'UCGABAR', 'MATCH'):
            if name and f' {op}' in line:
                counts.setdefault(name, {}).setdefault(op, 0)
                counts[name][op] += 1
    for name, ops in counts.items():
        if any(tag in name for tag in ('dft_power', 'conv', 'mfcc_mean',
                                       'speech_dnn', 'tuning_select',
                                       'rolloff_bins')):
            print(f'sass: {name[:100]}: {ops}')


def old_library(csrc, kernels):
    """Build those of DIR's sources that belong to `kernels` into a
    library of their own, each bound by its earlier C interface.
    Returns (library, the kernels it holds)."""
    have = [k for k in kernels if (Path(csrc) / SOURCES[k]).exists()]
    if not have:
        sys.exit(f'kernel_ab: none of {kernels} has a source in {csrc}')
    out = Path(tempfile.mkdtemp(prefix='kernel_ab_')) / 'libold.so'
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS[:-2], '-I', str(_build.CSRC),
           '-shared', '-o', str(out),
           *(str(Path(csrc) / SOURCES[k]) for k in have)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode:
        sys.exit(f'old build failed:\n{run.stdout}{run.stderr}')
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    ptrs = P * 10
    if 'k5' in have:
        lib.mec_dft_power.argtypes = [P, P, P, I, I, I, I, P, P, P]
    if 'k7' in have:
        lib.mec_layer1_int8.argtypes = [P, I, I, I, ptrs, ptrs, ptrs, P,
                                        P, P, P, P, P, P, P, P]
    if 'k1' in have:
        lib.mec_mfcc_mean.argtypes = [P, I, I, I, P, P, P, P, P, P]
    if 'k4' in have:
        lib.mec_speech_dnn.argtypes = [P, P, ctypes.POINTER(I), I, I, P, P]
    if 'k2' in have:
        lib.mec_tuning_select.argtypes = [P, P, P, I, I, P, P, P, P]
    if 'k3' in have:
        lib.mec_rolloff_bins.argtypes = [P, I, I, ctypes.c_float, P, P]
    return lib, have


def old_tuning(lib, mags, residual, pitches):
    """The one-block-a-clip K2 (32 bisection probes over all K keys)."""
    B, K = mags.shape
    best = torch.empty(B, dtype=torch.int32, device=mags.device)
    has = torch.empty(B, dtype=torch.bool, device=mags.device)
    err = lib.mec_tuning_select(
        mags.data_ptr(), residual.data_ptr(), pitches.data_ptr(), B, K,
        tk._edges(mags.device).data_ptr(), best.data_ptr(), has.data_ptr(),
        _build.stream(mags.device))
    assert err == 0, err
    return best, has


def old_rolloff(lib, rows):
    """The two-pass K3 (the row read twice, a scan a 32-bin chunk)."""
    out = torch.empty(rows.shape[0], dtype=torch.int32, device=rows.device)
    err = lib.mec_rolloff_bins(rows.data_ptr(), rows.shape[0], rows.shape[1],
                               0.85, out.data_ptr(),
                               _build.stream(rows.device))
    assert err == 0, err
    return out


def old_mfcc(lib, P):
    """The one-block-a-clip K1: dense mel table and its [lo, hi) runs."""
    mel, lo, hi, dct = sk._mel_tables(P.device)
    out = torch.empty((P.shape[0], sk.N_MFCC), dtype=torch.float32,
                      device=P.device)
    err = lib.mec_mfcc_mean(P.data_ptr(), P.shape[0], sk.N_FRAMES, sk.N_BINS,
                            mel.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                            dct.data_ptr(), out.data_ptr(),
                            _build.stream(P.device))
    assert err == 0, err
    return out


def old_dnn(lib, x, fwd):
    """The 8-row-tile K4, with the ctypes dims it built on every call."""
    out = torch.empty((x.shape[0], sk.PACKED_COLS), dtype=torch.float32,
                      device=x.device)
    c_dims = (ctypes.c_int * len(fwd.dims))(*fwd.dims)
    err = lib.mec_speech_dnn(x.data_ptr(), fwd.params.data_ptr(), c_dims,
                             len(fwd.dims) - 1, x.shape[0], out.data_ptr(),
                             _build.stream(x.device))
    assert err == 0, err
    return out


def clips_of(B, dev, rng, noise_only=False):
    """(B, 66150) seeded clips on dev: silence at row 0, then tones,
    chirps and noise, each over a noise floor; noise_only: noise at B
    loudnesses."""
    n = 66150
    t = np.arange(n) / 22050.0
    rows = [np.zeros(n)]
    for i in range(1, B):
        kind = i % 3
        if kind == 0:
            y = 0.3 * np.sin(2 * np.pi * (150 + 37 * i) * t)
        elif kind == 1:
            y = 0.2 * np.sin(2 * np.pi * (200 + 300 * t * i) * t)
        else:
            y = 0.02 * i * rng.randn(n)
        rows.append(y + 0.01 * rng.randn(n))
    if noise_only:
        rows = [0.01 * (i + 1) * rng.randn(n) for i in range(B)]
    return torch.from_numpy(np.stack(rows).astype(np.float32)).to(dev)


def frontend_inputs(B, dev, seed=0, noise_only=False, of=None):
    """K2's and K3's inputs as the hop-slab frontend makes them from
    clips_of: ((mags, residual, pitches), each (B, 23270); the (B * 130,
    1025) magnitude rows). of: make that many clips and keep the last B
    (no silent clip among them: K2's work depends on its data)."""
    y = clips_of(of or B, dev, np.random.RandomState(seed), noise_only)[-B:]
    mag, P = af.hop_spectrograms(y)
    mags, pitches = af.tuning_candidates(P)
    return ((mags, af.fold_residual(pitches), pitches),
            mag.reshape(-1, mag.shape[-1]).contiguous())


def power_of(B, dev, seed=0):
    """(B, 130, 1025) power spectrograms of clips_of's clips, and from
    B = 2 on row 1 a clip whose only sound is one loud frame (the clip's
    max lives in one block's frames)."""
    rng = np.random.RandomState(seed)
    P = af.hop_spectrograms(clips_of(B, dev, rng))[1].contiguous()
    if B >= 2:
        P[1] = 1e-12
        P[1, 77] = torch.from_numpy(
            rng.rand(sk.N_BINS).astype(np.float32) * 1e3).to(dev)
    return P


NARROW = (56, 32, 16, 7)


def narrow_tree(seed=3):
    """A narrow speech DNN (56-32-16-7) in the Flax layout."""
    rng = np.random.RandomState(seed)
    params, stats = {}, {}
    for i, (a, b) in enumerate(zip(NARROW[:-2], NARROW[1:-1])):
        params[f'dense_{i}'] = {
            'kernel': rng.randn(a, b).astype(np.float32) / np.sqrt(a),
            'bias': rng.randn(b).astype(np.float32) * 0.1}
        params[f'bn_{i}'] = {'scale': 1 + 0.1 * rng.randn(b).astype(np.float32),
                             'bias': 0.1 * rng.randn(b).astype(np.float32)}
        stats[f'bn_{i}'] = {'mean': 0.1 * rng.randn(b).astype(np.float32),
                            'var': 1 + 0.1 * rng.rand(b).astype(np.float32)}
    params['dense_out'] = {
        'kernel': rng.randn(*NARROW[-2:]).astype(np.float32) / 4,
        'bias': rng.randn(NARROW[-1]).astype(np.float32) * 0.1}
    return {'params': params, 'batch_stats': stats}


def check_speech(dev, kernels):
    ok = True
    if 'k1' in kernels:
        for B in (1, 2, 8, 32, 33):
            P = power_of(B, dev, seed=B)
            k, k2 = sk.mfcc_mean(P), sk.mfcc_mean(P)
            p = sk.mfcc_mean_plain(P)
            # the same algebra in fp64: which of the two carries the error
            mel, _lo, _hi, dct = (t.double() for t in sk._mel_tables(dev))
            db = 10.0 * torch.log10(torch.clamp_min(P.double() @ mel.T, 1e-10))
            db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
            ref = (db @ dct.T).mean(dim=1)
            torch.cuda.synchronize()
            ratio = ((k - p).abs() / (1e-4 + 2e-6 * p.abs())).max().item()
            same = torch.equal(k, k2)
            good = ratio <= 1.0 and same and bool(torch.isfinite(k).all())
            ok &= good
            print(f'K1 B={B:2d} split {sk.frame_split(B)}: max|err| '
                  f'{(k - p).abs().max().item():.3e}, worst |err| / (1e-4 + '
                  f'2e-6|p|) {ratio:.3f}, two runs '
                  f'{"equal" if same else "DIFFER"}; against fp64: kernel '
                  f'{(k - ref).abs().max().item():.3e}, plain '
                  f'{(p - ref).abs().max().item():.3e} '
                  f'{"ok" if good else "FAIL"}')
    if 'k2' in kernels:
        K = 130 * 179
        gen = torch.Generator(device=dev).manual_seed(0)
        every = torch.rand(2, K, device=dev, generator=gen) + 0.5
        tied = torch.floor(torch.rand(2, K, device=dev, generator=gen) * 4)
        spread = torch.rand(2, K, device=dev, generator=gen) - 0.5
        cases = [(f'B={B:2d}', frontend_inputs(B, dev, seed=B)[0])
                 for B in (1, 8, 32, 33)]
        cases += [('noise-only B=8', frontend_inputs(8, dev, 1, True)[0]),
                  ('silent clip', frontend_inputs(1, dev)[0]),
                  ('every slot a candidate', (every, spread, every)),
                  ('every slot, tied magnitudes', (tied + 1, spread, every))]
        for what, (mags, residual, pitches) in cases:
            kb, kh = tk.tuning_select(mags, residual, pitches)
            kb2, kh2 = tk.tuning_select(mags, residual, pitches)
            pb, ph = tk.tuning_select_plain(mags, residual, pitches)
            torch.cuda.synchronize()
            good = (torch.equal(kb, pb) and torch.equal(kh, ph)
                    and torch.equal(kb, kb2) and torch.equal(kh, kh2))
            ok &= good
            share = (pitches > 0).float().mean().item()
            print(f'K2 {what}: a cluster of {tk.cluster_split(mags.shape[0])}'
                  f' blocks a clip, {share:.3f} of the slots are candidates, '
                  f'{int(kh.sum())}/{mags.shape[0]} clips select; bit-exact '
                  f'and two runs equal: {"ok" if good else "FAIL"}')
    if 'k3' in kernels:
        for B in (1, 8, 32, 33):
            rows = frontend_inputs(B, dev, seed=B)[1]
            rows = torch.cat([rows, torch.zeros_like(rows[:1])])
            k, p = rk.rolloff_bins(rows), rk.rolloff_bins_plain(rows)
            torch.cuda.synchronize()
            bad = torch.nonzero(k != p).flatten().tolist()
            good = k[-1].item() == 0
            for r in bad:
                cum = torch.cumsum(rows[r].double(), 0)
                lo_bin = min(k[r].item(), p[r].item())
                tie = abs(cum[lo_bin].item() - 0.85 * cum[-1].item())
                good &= (abs(k[r].item() - p[r].item()) == 1 and tie
                         <= rows.shape[1] * 2.0 ** -24 * cum[-1].item())
            ok &= good
            print(f'K3 B={B:2d}: {rk.rows_per_block(rows.shape[0])} rows a '
                  f'block, {len(bad)} of {rows.shape[0]} '
                  f'rows differ from the plain version, each a one-bin '
                  f'near-tie; the all-zero row gives bin {k[-1].item()}: '
                  f'{"ok" if good else "FAIL"}')
    if 'k4' in kernels:
        for what, tree in (('full', speech_variables(seed=2)),
                           ('narrow', narrow_tree())):
            fwd = sk.make_speech_dnn(tree, dev)
            n_cls, pen = fwd.dims[-1], min(fwd.dims[-2], 128 - fwd.dims[-1])
            for B in (1, 8, 9, 32, 33, 64):
                x = torch.from_numpy(np.random.RandomState(B).randn(
                    B, 56).astype(np.float32)).to(dev)
                k = fwd(x)
                p = sk.speech_dnn_plain(x, fwd.params, fwd.dims)
                torch.cuda.synchronize()
                e_prob = (k[:, :n_cls] - p[:, :n_cls]).abs().max().item()
                e_pen = (k[:, n_cls:] - p[:, n_cls:]).abs().max().item()
                good = (e_prob <= 2e-6 and e_pen <= 2e-5
                        and bool((k[:, n_cls + pen:] == 0).all()))
                ok &= good
                print(f'K4 {what:6s} {fwd.dims} B={B:2d} grid '
                      f'{sk.dnn_grid(B)} x {sk.DNN_CLUSTER}: probs max|err| '
                      f'{e_prob:.3e}, penult {e_pen:.3e} '
                      f'{"ok" if good else "FAIL"}')
    return ok


def device_us(fn, reps):
    """Median device time (us) of a call of fn(): the summed durations of
    its device launches in a torch.profiler window of reps calls. The
    profiler now and then loses launches of a window: such a window is
    taken again, once, and if that one is short too the time is put
    together by kernel name (the median duration of each name times its
    launches a call)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        n = len(kern) // reps
        if n and len(kern) == n * reps:
            return statistics.median(
                sum(e.time_range.elapsed_us() for e in kern[i:i + n])
                for i in range(0, n * reps, n))
        print(f'kernel_ab: {len(kern)} device launches in {reps} calls'
              + (', profiling again' if attempt == 0 else
                 ', timing by kernel name'))
    if len(kern) <= reps // 2:
        sys.exit('kernel_ab: the profiler lost most launches, twice')
    by_name = {}
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return sum(max(1, round(len(d) / reps)) * statistics.median(d)
               for d in by_name.values())


def time_speech(dev, kernels, old, old_have, args, card):
    fwd = sk.make_speech_dnn(speech_variables(seed=2), dev)
    for B in (32, 8, 1):
        P = power_of(B, dev)
        x = torch.from_numpy(np.random.RandomState(B).randn(B, 56)
                             .astype(np.float32)).to(dev)
        sel, rows = frontend_inputs(B, dev, of=32)
        cases = []
        if 'k1' in kernels:
            cases.append(('K1', 'k1', lambda: sk.mfcc_mean(P),
                          lambda: old_mfcc(old, P)))
        if 'k2' in kernels:
            cases.append(('K2', 'k2', lambda: tk.tuning_select(*sel),
                          lambda: old_tuning(old, *sel)))
        if 'k3' in kernels:
            cases.append(('K3', 'k3', lambda: rk.rolloff_bins(rows),
                          lambda: old_rolloff(old, rows)))
        if 'k4' in kernels:
            cases.append(('K4', 'k4', lambda: fwd(x),
                          lambda: old_dnn(old, x, fwd)))
        for name, key, new_fn, old_fn in cases:
            if key not in old_have:
                line = f'new {cuda_ms(new_fn, args.reps):.4f} ms by events'
                if args.profile:
                    line += f', {device_us(new_fn, args.reps):.1f} us on the device'
                print(f'time {name} B={B}: {line} (median of {args.reps}; {card})')
                continue
            order = (old_fn, new_fn, new_fn, old_fn)
            o1, n1, n2, o2 = (cuda_ms(f, args.reps) for f in order)
            line = (f'old {statistics.median([o1, o2]):.4f} ms [{o1:.4f}, '
                    f'{o2:.4f}], new {statistics.median([n1, n2]):.4f} ms '
                    f'[{n1:.4f}, {n2:.4f}] by events')
            if args.profile:
                o1, n1, n2, o2 = (device_us(f, args.reps) for f in order)
                line += (f'; on the device old {statistics.median([o1, o2]):.1f}'
                         f' us [{o1:.1f}, {o2:.1f}], new '
                         f'{statistics.median([n1, n2]):.1f} us [{n1:.1f}, '
                         f'{n2:.1f}]')
            print(f'time {name} B={B}: {line} (medians of {args.reps}, in '
                  f'turns old, new, new, old; {card})')


K4_MARKS = (['ask for every copy', 'cluster.sync (all blocks run)']
            + [f'L{n} {what}' for n in range(5) for what in (
                'wait for weights', 'products + fold', 'slabs, bias, ReLU',
                'exchange', 'cluster.sync')]
            + ['wait for weights', 'output layer, softmax, rows'])
K2_MARKS = (['stream the slice, keep and count the candidates',
             'gather in block 0 (split barrier, copies, cluster.sync)',
             'scan the top-digit counts, pick', 'the bin to the short list']
            + [f'round {r}: digit histogram, scan, pick' for r in range(2)]
            + ['count <= lower middle, next key',
               'selection, bin histogram, argmax'])
K1_MARKS = ['ask for copies, tables land', 'frames: copy, mel, dB',
            'block max, tell the cluster, cluster.sync',
            'clip max, clamped time sums', 'cluster.sync',
            'block 0: mean and DCT']


def trace_phases(dev, kernels, card):
    """Build K1 / K4 alone with -DMEC_TRACE and print the clocks between
    the marks of the last of five launches."""
    P_, I = ctypes.c_void_p, ctypes.c_int
    fwd = sk.make_speech_dnn(speech_variables(seed=2), dev)
    tk._lib()
    for key, marks in (('k1', K1_MARKS), ('k2', K2_MARKS), ('k4', K4_MARKS)):
        if key not in kernels:
            continue
        out = Path(tempfile.mkdtemp(prefix='kernel_ab_')) / 'libtrace.so'
        run = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS[:-2], '-DMEC_TRACE', '-shared',
             '-o', str(out), str(_build.CSRC / SOURCES[key])],
            capture_output=True, text=True)
        if run.returncode:
            sys.exit(f'trace build failed:\n{run.stdout}{run.stderr}')
        lib = ctypes.CDLL(str(out))
        lib.mec_trace_read.argtypes = [P_, P_]
        for B in (1, 32):
            if key == 'k1':
                lib.mec_mfcc_mean.argtypes = sk._lib_mfcc().mec_mfcc_mean.argtypes
                P = power_of(B, dev)
                taps, runs, dct, n_taps = sk._kernel_tables(P.device)
                res = torch.empty((B, sk.N_MFCC), device=dev)

                def launch():
                    return lib.mec_mfcc_mean(
                        P.data_ptr(), B, sk.N_FRAMES, sk.N_BINS,
                        taps.data_ptr(), n_taps, runs.data_ptr(),
                        dct.data_ptr(), sk.frame_split(B), res.data_ptr(),
                        _build.stream(dev))
            elif key == 'k2':
                # block 0 is clip 0's: a noise clip, many candidates
                lib.mec_tuning_select.argtypes = tk._lib().mec_tuning_select.argtypes
                sel = frontend_inputs(B, dev, noise_only=True)[0]
                best = torch.empty(B, dtype=torch.int32, device=dev)
                has = torch.empty(B, dtype=torch.bool, device=dev)
                print(f'trace K2 B={B}: clip 0 has '
                      f'{int((sel[2][0] > 0).sum())} candidates')

                def launch():
                    return lib.mec_tuning_select(
                        *(t.data_ptr() for t in sel), B, sel[0].shape[1],
                        tk.cluster_split(B), tk._edges(dev).data_ptr(),
                        best.data_ptr(), has.data_ptr(), _build.stream(dev))
            else:
                lib.mec_speech_dnn.argtypes = sk._lib_dnn().mec_speech_dnn.argtypes
                x = torch.randn(B, 56, device=dev)
                res = torch.empty((B, 128), device=dev)

                def launch():
                    return lib.mec_speech_dnn(
                        x.data_ptr(), fwd.params.data_ptr(), fwd.c_dims,
                        len(fwd.dims) - 1, B, sk.DNN_CLUSTER, res.data_ptr(),
                        _build.stream(dev))
            for _ in range(5):
                err = launch()
                assert err == 0, err
                torch.cuda.synchronize()
            clocks = (ctypes.c_longlong * 128)()
            count = I()
            err = lib.mec_trace_read(ctypes.addressof(clocks),
                                     ctypes.addressof(count))
            assert err == 0, err
            steps = np.diff(np.array(clocks[:count.value]))
            names = marks if len(marks) == len(steps) else [
                f'mark {i}' for i in range(len(steps))]
            print(f'trace {key.upper()} B={B}: {int(steps.sum())} clocks in '
                  f'block 0 ({card}): '
                  + ', '.join(f'{n} {v}' for n, v in zip(names, steps)))


def variant_times(dev, kernels, reps, card):
    """K4 at other cluster sizes and K1 at other frame splits, through
    the C interface (device time; a refused launch is reported)."""
    lib = _build.library()
    sk._lib_mfcc(), sk._lib_dnn(), tk._lib(), rk._lib()
    fwd = sk.make_speech_dnn(speech_variables(seed=2), dev)
    for B in (32, 8, 1):
        (mags, residual, pitches), rows = frontend_inputs(B, dev, of=32)
        if 'k2' in kernels:
            best = torch.empty(B, dtype=torch.int32, device=dev)
            has = torch.empty(B, dtype=torch.bool, device=dev)
            want = tk.tuning_select_plain(mags, residual, pitches)
            for split in (1, 2, 4, 8):
                def run():
                    return lib.mec_tuning_select(
                        mags.data_ptr(), residual.data_ptr(),
                        pitches.data_ptr(), B, mags.shape[1], split,
                        tk._edges(dev).data_ptr(), best.data_ptr(),
                        has.data_ptr(), _build.stream(dev))
                err = run()
                if err:
                    print(f'variant K2 B={B} split {split}: launch refused, '
                          f'CUDA error {err}')
                    continue
                same = torch.equal(best, want[0]) and torch.equal(has, want[1])

                def run_checked():
                    assert run() == 0, 'a launch failed in the timed window'
                print(f'variant K2 B={B} split {split}: '
                      f'{device_us(run_checked, reps):.1f} us on the device, '
                      f'{"bit-exact" if same else "WRONG"} ({card})')
        if 'k3' in kernels:
            out = torch.empty(rows.shape[0], dtype=torch.int32, device=dev)
            want = rk.rolloff_bins(rows)
            for warps in (1, 2, 4, 8):
                def run():
                    return lib.mec_rolloff_bins(
                        rows.data_ptr(), rows.shape[0], rows.shape[1], 0.85,
                        warps, out.data_ptr(), _build.stream(dev))
                err = run()
                if err:
                    print(f'variant K3 B={B} rows a block {warps}: launch '
                          f'refused, CUDA error {err}')
                    continue
                same = torch.equal(out, want)
                print(f'variant K3 B={B} rows a block {warps}: '
                      f'{device_us(run, reps):.1f} us on the device, '
                      f'{"same bins" if same else "WRONG"} ({card})')
        if B == 8:
            continue
        if 'k4' in kernels:
            x = torch.from_numpy(np.random.RandomState(B).randn(B, 56)
                                 .astype(np.float32)).to(dev)
            out = torch.empty((B, 128), device=dev)
            for cluster in (8, 16):
                def run():
                    return lib.mec_speech_dnn(
                        x.data_ptr(), fwd.params.data_ptr(), fwd.c_dims,
                        len(fwd.dims) - 1, B, cluster, out.data_ptr(),
                        _build.stream(dev))
                err = run()
                if err:
                    print(f'variant K4 B={B} cluster {cluster}: launch '
                          f'refused, CUDA error {err}')
                    continue
                print(f'variant K4 B={B} cluster {cluster}: '
                      f'{device_us(run, reps):.1f} us on the device ({card})')
        if 'k1' in kernels:
            P = power_of(B, dev)
            taps, runs, dct, n_taps = sk._kernel_tables(P.device)
            out = torch.empty((B, sk.N_MFCC), device=dev)
            for split in (5, 10, 13):
                def run():
                    return lib.mec_mfcc_mean(
                        P.data_ptr(), B, sk.N_FRAMES, sk.N_BINS,
                        taps.data_ptr(), n_taps, runs.data_ptr(),
                        dct.data_ptr(), split, out.data_ptr(),
                        _build.stream(dev))
                err = run()
                if err:
                    print(f'variant K1 B={B} split {split}: launch refused, '
                          f'CUDA error {err}')
                    continue
                ref = sk.mfcc_mean_plain(P)
                worst = ((out - ref).abs() / (1e-4 + 2e-6 * ref.abs())).max()
                print(f'variant K1 B={B} split {split}: '
                      f'{device_us(run, reps):.1f} us on the device, worst '
                      f'|err| / (1e-4 + 2e-6|p|) {worst.item():.3f} ({card})')


def old_dft(lib, frames, precision):
    B, T, _ = frames.shape
    cos, sin = dft_kernel._bases(frames.device, precision)
    P = torch.empty((B, T, 1025), dtype=torch.float32, device=frames.device)
    mag = torch.empty_like(P)
    err = lib.mec_dft_power(frames.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                            B * T, 2048, 1025, int(precision == 'bf16'),
                            P.data_ptr(), mag.data_ptr(),
                            _build.stream(frames.device))
    assert err == 0, err
    return mag, P


def old_layer1(lib, x, blocks):
    convs = resnet_kernel._convs(blocks)
    B, H, W, _ = x.shape
    M, dev = B * H * W, x.device
    ptrs = ctypes.c_void_p * 10
    scales = torch.stack([c.act_scale for c in convs])
    i8 = dict(dtype=torch.int8, device=dev)
    qa, qd, h1q, h2q = (torch.empty((M, 64), **i8) for _ in range(4))
    resq = torch.empty((M, 256), **i8)
    ident = torch.empty((M, 256), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, H, W, 256), dtype=torch.bfloat16, device=dev)
    err = lib.mec_layer1_int8(
        x.data_ptr(), B, H, W,
        ptrs(*(c.kernel_q.data_ptr() for c in convs)),
        ptrs(*(c.kernel_scale.data_ptr() for c in convs)),
        ptrs(*(c.bias.data_ptr() for c in convs)),
        scales.data_ptr(), qa.data_ptr(), qd.data_ptr(), h1q.data_ptr(),
        h2q.data_ptr(), resq.data_ptr(), ident.data_ptr(), out.data_ptr(),
        _build.stream(dev))
    assert err == 0, err
    return out


def split_times(dev, reps):
    """K5's time at B=32 as a line in the contraction length: the kernel
    is launched on (4160, K) stand-in frames and tables for K = 2048,
    1024 and 512 (the values are noise; only the time is read). The
    slope is the main loop's time per 32-deep step, the intercept the
    launch, the pipeline's fill and the epilogue."""
    lib = dft_kernel._lib()
    M, N = 4160, dft_kernel.N_BINS
    gen = torch.Generator(device=dev).manual_seed(0)
    for prec in dft_kernel.PRECISIONS:
        ms = {}
        for K in (2048, 1024, 512):
            frames = torch.randn(M, K, device=dev, generator=gen) * 0.1
            if prec == 'bf16':
                cos = torch.randn(dft_kernel.N_PAD, K, device=dev,
                                  generator=gen).to(torch.bfloat16)
                sin, nyq = cos.clone(), torch.empty(0, device=dev)
            else:
                cos = torch.randn(K, dft_kernel.N_TILED, device=dev,
                                  generator=gen)
                sin, nyq = cos.clone(), torch.randn(2, K, device=dev,
                                                    generator=gen)
            P = torch.empty(M, N, device=dev)
            mag = torch.empty_like(P)
            bm, bn, _, _ = dft_kernel.tile_grid(M)

            def run():
                err = lib.mec_dft_power(
                    frames.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                    nyq.data_ptr(), M, K, N, int(prec == 'bf16'), bm, bn,
                    P.data_ptr(), mag.data_ptr(), _build.stream(dev))
                assert err == 0, err
            ms[K] = cuda_ms(run, reps)
        slope = (ms[2048] - ms[1024]) / 32
        print(f'split K5 {prec} B=32: K=2048 {ms[2048]:.4f} ms, K=1024 '
              f'{ms[1024]:.4f} ms, K=512 {ms[512]:.4f} ms: {slope * 1e3:.3f}'
              f' us a 32-deep step, {ms[2048] - 64 * slope:.4f} ms beside '
              f'the loop')


DRIFT_TEXTS = ['i am so happy today', 'this is terrible and sad',
               'wow what a surprise', 'i feel angry about all of this',
               'the day was calm', 'i hate this awful news',
               'really not great', 'yes i love it and you']
DRIFT_STAGES = ('query', 'key', 'value', 'scores', 'softmax', 'context',
                'attention_output', 'attention_norm', 'intermediate', 'gelu',
                'output', 'output_norm')


def bert_layer_stages(layer, h, bias, forced=None):
    """models.bert.BertLayer.forward, stage by stage: {stage: its
    output}. With `forced` (another run's stages), every stage after the
    first computes on that run's values instead of its own, so each
    output shows what this device makes of the very same input."""
    import torch.nn.functional as F
    out = {}

    def keep(name, value):
        out[name] = value
        return value if forced is None else forced[name].to(value.device)

    att = layer.attention_self
    B, L, H = h.shape

    def split(t):
        return t.reshape(B, L, att.heads, H // att.heads).transpose(1, 2)

    q = keep('query', att.query(h))
    k = keep('key', att.key(h))
    v = keep('value', att.value(h))
    scores = keep('scores', (split(q) @ split(k).transpose(-1, -2))
                  / att.scale + bias[:, None, None, :])
    probs = keep('softmax', torch.softmax(scores.float(), dim=-1)
                 .to(att.dtype))
    ctx = keep('context', (probs @ split(v)).transpose(1, 2).reshape(B, L, H))
    ao = keep('attention_output', layer.attention_output(ctx))
    h1 = keep('attention_norm', layer.attention_norm(h + ao))
    inter = keep('intermediate', layer.intermediate(h1))
    act = keep('gelu', F.gelu(inter, approximate=layer.gelu))
    o = keep('output', layer.output(act))
    keep('output_norm', layer.output_norm(h1 + o))
    return out


def _gap(a, b):
    """Largest |a - b| over the entries where either is finite (the
    masked scores are -inf on both)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    d = (a - b).abs()
    return float(torch.where(a == b, torch.zeros_like(d), d).max())


def bert_drift(dev, card):
    """Where the int8-static BERT on the card leaves the same model on
    the CPU. Free run: both models on the same ids, the hidden state
    compared after the embeddings and after every layer, and the int8
    codes that each QuantDense hands to torch._int_mm compared code by
    code. Same-input run: every stage of every layer is given the CPU
    run's input on the card, so a nonzero gap names an operation whose
    result differs between the devices on identical operands."""
    from mec_tpu_torch.models.qconv import QuantDense
    from mec_tpu_torch.ops.quant import extract_static_scales
    from mec_tpu_torch.serving.engine import EmotionEngine
    from mec_tpu_torch.serving.synthetic_artifacts import (bert_variables,
                                                           make_vocab)
    kwargs = dict(vocab_size=30522, hidden_size=768, num_layers=12,
                  num_heads=12, intermediate_size=3072, max_position=512,
                  type_vocab_size=2, num_classes=7)
    trees = dict(bert_variables=bert_variables(seed=0), bert_kwargs=kwargs,
                 bert_vocab=make_vocab(), compute_dtype='bfloat16')
    on_card = EmotionEngine(device='cuda', **trees)
    scales = {on_card._bert_scales_key():
              extract_static_scales(on_card.bert['variables'])}
    on_cpu = EmotionEngine(device='cpu', bert_meta={'int8_scales': scales},
                           **trees)
    assert on_card._bert_quant_mode == on_cpu._bert_quant_mode == 'static'
    ids, mask = on_card._text_wire(DRIFT_TEXTS, 8)
    models = {'card': on_card.bert['model'], 'cpu': on_cpu.bert['model']}
    free, codes, packed = {}, {}, {}
    for where, model in models.items():
        hidden, ops, hooks = {}, {}, []
        for name, mod in model.named_modules():
            if name == 'embeddings_norm' or name.startswith('layer_') \
                    and '.' not in name:
                hooks.append(mod.register_forward_hook(
                    lambda m, i, o, name=name: hidden.__setitem__(name, o)))
            if isinstance(mod, QuantDense):
                hooks.append(mod.register_forward_hook(
                    lambda m, i, o, name=name: ops.__setitem__(
                        name, torch.clamp(torch.round(
                            i[0].float() / m.act_scale), -127, 127
                        ).to(torch.int8).cpu())))
        eng = on_card if where == 'card' else on_cpu
        with torch.inference_mode():
            packed[where] = eng._text_forward(
                *eng._to_device((ids, mask))).float().cpu()
        for hook in hooks:
            hook.remove()
        free[where], codes[where] = hidden, ops
    print(f'bert-drift: BERT-base 12 x 768, bf16 int8 static, the card\'s '
          f'scales on both, {len(DRIFT_TEXTS)} texts x {ids.shape[1]} tokens '
          f'({card} against this host\'s CPU)')
    print(f'bert-drift free run: after the embeddings max|dh| '
          f'{_gap(free["card"]["embeddings_norm"], free["cpu"]["embeddings_norm"]):.4g}')
    for i in range(kwargs['num_layers']):
        name = f'layer_{i}'
        diff = []
        for op in ('attention_self.query', 'attention_self.key',
                   'attention_self.value', 'attention_output', 'intermediate',
                   'output'):
            a, b = codes['card'][f'{name}.{op}'], codes['cpu'][f'{name}.{op}']
            n_bad = int((a != b).sum())
            diff.append(f'{op.split(".")[-1]} '
                        + ('equal' if n_bad == 0 else
                           f'{n_bad}/{a.numel()} differ (max '
                           f'{int((a.int() - b.int()).abs().max())})'))
        print(f'bert-drift free run: after {name} max|dh| '
              f'{_gap(free["card"][name], free["cpu"][name]):.4g}; int8 '
              f'operands: ' + ', '.join(diff))
    probs = {w: packed[w][:, :7] for w in packed}
    print(f'bert-drift free run: probabilities max|d| '
          f'{_gap(probs["card"], probs["cpu"]):.4g}, CLS max|d| '
          f'{_gap(packed["card"][:, 7:], packed["cpu"][:, 7:]):.4g}, '
          f'decisions equal: '
          f'{bool((probs["card"].argmax(1) == probs["cpu"].argmax(1)).all())}')
    # every stage on the card from the CPU run's operands
    worst = {stage: 0.0 for stage in DRIFT_STAGES}
    with torch.inference_mode():
        bias = {w: ((1.0 - torch.from_numpy(mask).to(m.neg.device).float())
                    * m.neg).to(m.dtype) for w, m in models.items()}
        for i in range(kwargs['num_layers']):
            h_in = free['cpu']['embeddings_norm' if i == 0
                               else f'layer_{i - 1}']
            ref = bert_layer_stages(getattr(models['cpu'], f'layer_{i}'),
                                    h_in, bias['cpu'])
            got = bert_layer_stages(getattr(models['card'], f'layer_{i}'),
                                    h_in.to(dev), bias['card'], forced=ref)
            gaps = {stage: _gap(got[stage], ref[stage])
                    for stage in DRIFT_STAGES}
            for stage, g in gaps.items():
                worst[stage] = max(worst[stage], g)
            print(f'bert-drift same input: layer_{i} '
                  + ', '.join(f'{stage} {g:.3g}' for stage, g in gaps.items()
                              if g > 0.0)
                  + ('' if any(gaps.values()) else 'every stage bit-equal'))
    exact = [s_ for s_, g in worst.items() if g == 0.0]
    print('bert-drift same input: bit-equal on both devices in every layer: '
          + (', '.join(exact) or 'no stage')
          + '; differing: ' + (', '.join(
              f'{s_} (max {g:.3g})' for s_, g in worst.items() if g > 0.0)
              or 'none'))


MOBILENET_STAGES = ('expand_conv', 'expand_relu6', 'dw_conv', 'dw_relu6',
                    'project_conv', 'residual')


def mobilenet_block_stages(block, x, forced=None):
    """models.mobilenet.InvertedResidual.forward (folded, int8), stage by
    stage: {stage: its output}; with `forced`, each stage computes on
    that run's input to it (bert_layer_stages' scheme)."""
    import torch.nn.functional as F
    out = {}

    def keep(name, value):
        out[name] = value
        return value if forced is None else forced[name].to(value.device)

    h = x
    if block.has_expand:
        h = keep('expand_conv', block.expand_conv(h))
        h = keep('expand_relu6', F.relu6(h))
    h = keep('dw_conv', block.dw_conv(h))
    h = keep('dw_relu6', F.relu6(h))
    h = keep('project_conv', block.project_conv(h))
    if block.residual:
        keep('residual', h + x)
    return out


def mobilenet_drift(dev, card, seed=3):
    """Where the bf16 int8-static MobileNetV2 (224 px) on the card leaves
    the same model on the CPU, as bert_drift does for BERT, at B = 1 and
    4: free run (the stem's output, each block's output and each
    QuantConv's int8 operand compared; blocks with no difference are
    counted, not printed), then every stage of every block computed on
    the card from the CPU run's operands. seed 3 is chip_smoke.py's
    models-directory image (MODELS_SEED + 2)."""
    from mec_tpu_torch.models.qconv import QuantConv
    from mec_tpu_torch.ops.quant import extract_static_scales
    from mec_tpu_torch.serving.engine import EmotionEngine
    from mec_tpu_torch.serving.synthetic_artifacts import mobilenet_variables
    tree, meta = mobilenet_variables(seed=seed, image_size=224)
    on_card = EmotionEngine(image_variables=tree, image_meta=meta,
                            compute_dtype='bfloat16', device='cuda')
    scales = {on_card._image_scales_key():
              extract_static_scales(on_card.image['variables'])}
    on_cpu = EmotionEngine(image_variables=tree,
                           image_meta=dict(meta, int8_scales=scales),
                           compute_dtype='bfloat16', device='cpu')
    models = {'card': on_card.image['model'], 'cpu': on_cpu.image['model']}
    blocks = models['cpu'].blocks
    for B in (1, 4):
        imgs = np.random.RandomState(8).randint(0, 256, (4, 224, 224, 3),
                                                np.uint8)[:B]
        free, codes, packed = {}, {}, {}
        for where, model in models.items():
            seen, ops, hooks = {}, {}, []
            for name, mod in model.named_modules():
                if name in blocks:
                    hooks.append(mod.register_forward_hook(
                        lambda m, i, o, name=name: seen.__setitem__(
                            name, (i[0], o))))
                if isinstance(mod, QuantConv):
                    hooks.append(mod.register_forward_hook(
                        lambda m, i, o, name=name: ops.__setitem__(
                            name, torch.clamp(torch.round(
                                i[0].float() / m.act_scale), -127, 127
                            ).to(torch.int8).cpu())))
            eng = on_card if where == 'card' else on_cpu
            with torch.inference_mode():
                packed[where] = eng._image_forward(eng._to_device(
                    eng._wire_image(imgs, eng._bucket(B))))[:B].float().cpu()
            for hook in hooks:
                hook.remove()
            free[where], codes[where] = seen, ops
        print(f'mobilenet-drift B={B}: MobileNetV2 224 px, bf16 int8 '
              f"static, the card's scales on both ({card} against this "
              f"host's CPU); free run: the stem's output max|dh| "
              f'{_gap(free["card"]["block_1"][0], free["cpu"]["block_1"][0]):.4g}')
        quiet = 0
        for name in blocks + ['conv_head']:
            diff = []
            for op, a in codes['card'].items():
                if op == name or op.startswith(name + '.'):
                    n_bad = int((a != codes['cpu'][op]).sum())
                    if n_bad:
                        diff.append(f'{op}: {n_bad}/{a.numel()} int8 codes '
                                    f'differ')
            gap = (_gap(free['card'][name][1], free['cpu'][name][1])
                   if name in blocks else 0.0)
            if gap == 0.0 and not diff:
                quiet += 1
                continue
            print(f'mobilenet-drift B={B} free run: {name} max|dh| {gap:.4g}'
                  + ''.join('; ' + d for d in diff))
        probs = {w: packed[w][:, :7] for w in packed}
        print(f'mobilenet-drift B={B} free run: {quiet} of '
              f'{len(blocks) + 1} (the blocks and conv_head) equal on both; '
              f'probabilities max|d| '
              f'{_gap(probs["card"], probs["cpu"]):.4g}, feature max|d| '
              f'{_gap(packed["card"][:, 7:], packed["cpu"][:, 7:]):.4g}, '
              f'decisions equal: '
              f'{bool((probs["card"].argmax(1) == probs["cpu"].argmax(1)).all())}')
        worst = {stage: 0.0 for stage in MOBILENET_STAGES}
        with torch.inference_mode():
            for name in blocks:
                x_in = free['cpu'][name][0]
                ref = mobilenet_block_stages(getattr(models['cpu'], name),
                                             x_in)
                got = mobilenet_block_stages(getattr(models['card'], name),
                                             x_in.to(dev), forced=ref)
                for stage in ref:
                    worst[stage] = max(worst[stage],
                                       _gap(got[stage], ref[stage]))
        print(f'mobilenet-drift B={B} same input: bit-equal on both devices '
              'in every block: ' + (', '.join(
                  st for st, g in worst.items() if g == 0.0) or 'no stage')
              + '; differing: ' + (', '.join(
                  f'{st} (max {g:.3g})' for st, g in worst.items() if g > 0.0)
                  or 'none'))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--kernels', default='k1,k2,k3,k4,k5,k7',
                    help='which of k1,k2,k3,k4,k5,k7 to report, check and '
                    'time')
    ap.add_argument('--old-csrc', help='directory with earlier sources of '
                    'these kernels to time in turns')
    ap.add_argument('--reps', type=int, default=30)
    ap.add_argument('--split', action='store_true', help="K5's time as a "
                    'line in the contraction length (loop against epilogue)')
    ap.add_argument('--profile', action='store_true', help='device time '
                    'of each launch (torch.profiler)')
    ap.add_argument('--variants', action='store_true', help='K4 and K2 at '
                    'other cluster sizes, K1 at other frame splits, K3 at '
                    'other rows a block')
    ap.add_argument('--trace', action='store_true', help='clocks between '
                    "the phase marks of K1's, K2's and K4's sources")
    ap.add_argument('--bert-drift', action='store_true', help='only this: '
                    'where the int8-static BERT on the card leaves the same '
                    'model on the CPU, layer by layer and stage by stage')
    ap.add_argument('--mobilenet-drift', action='store_true', help='only '
                    'this: the same for the int8-static MobileNetV2, block '
                    'by block and stage by stage')
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(',') if k]
    if not kernels or set(kernels) - set(SOURCES):
        sys.exit(f'kernel_ab: --kernels takes some of {sorted(SOURCES)}')
    if not torch.cuda.is_available():
        sys.exit('kernel_ab: needs an NVIDIA GPU')
    dev = torch.device('cuda')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f'card: {card} | torch {torch.__version__}')
    if args.bert_drift or args.mobilenet_drift:
        if args.bert_drift:
            bert_drift(dev, card)
        if args.mobilenet_drift:
            mobilenet_drift(dev, card)
        print('kernel_ab: ok')
        return
    build_report(kernels)
    ok = check_speech(dev, kernels)

    # ------------------------------------------------------- K5 checks
    # the fp64 reference takes the operands the precision takes (for
    # 'bf16' the rounded frames and tables), so it shows what the fp32
    # summation alone costs each version
    for m in (1, 130, 131, 4160) if 'k5' in kernels else ():
        frames = frames_of(m, dev, seed=m)
        for prec in dft_kernel.PRECISIONS:
            cos64, sin64 = (t.double() for t in dft_kernel._bases(dev, prec))
            flat = frames[0]
            if prec == 'bf16':
                flat = flat.to(torch.bfloat16)
            flat = flat.double()
            ref_mag = torch.sqrt((flat @ cos64) ** 2 + (flat @ sin64) ** 2)
            km, kp = dft_kernel.dft_spectrograms(frames, prec)
            pm, pp = dft_kernel.dft_spectrograms_plain(frames, prec)
            torch.cuda.synchronize()
            e_mag = (km - pm).abs().max().item()
            rel = ((kp - pp).abs() / (pp + 1e-6)).max().item()
            e_nyq = (km[..., -1] - pm[..., -1]).abs().max().item()
            e64_k = (km[0].double() - ref_mag).abs().max().item()
            e64_p = (pm[0].double() - ref_mag).abs().max().item()
            good = e_mag <= MAG_ATOL and rel <= P_REL
            ok &= good
            print(f'K5 {prec:7s} M={m:4d} tile {dft_kernel.tile_grid(m)}: '
                  f'mag max|err| {e_mag:.3e} (bin 1024: {e_nyq:.3e}), P max '
                  f'rel {rel:.3e}; mag against fp64 sums of the same '
                  f'operands: kernel {e64_k:.3e}, plain {e64_p:.3e}, largest '
                  f'mag {ref_mag.max().item():.2f} '
                  f'{"ok" if good else "FAIL"}')

    # ------------------------------------------------------- K7 checks
    blocks = layer1_blocks(dev) if 'k7' in kernels else None
    for shape in ((1, 56, 56, 64), (2, 56, 56, 64), (32, 56, 56, 64),
                  (2, 13, 9, 64), (3, 57, 55, 64)) if blocks else ():
        x = torch.from_numpy(np.abs(np.random.RandomState(1).randn(*shape))
                             .astype(np.float32)).to(dev, torch.bfloat16)
        with torch.inference_mode():
            k = resnet_kernel.layer1(x, blocks)
            p = resnet_kernel.layer1_plain(x, blocks)
        torch.cuda.synchronize()
        same = torch.equal(k, p)
        ok &= same
        n_bad = int((k != p).sum())
        err = (k.float() - p.float()).abs().max().item()
        m = shape[0] * shape[1] * shape[2]
        print(f'K7 {shape} tile {resnet_kernel.pixel_tile(m)}: '
              f'{"bit-exact" if same else "FAIL"} ({n_bad} of {k.numel()} '
              f'differ, max|err| {err:.3e})')
    if not ok:
        sys.exit('kernel_ab: a check failed')

    # ----------------------------------------------------------- times
    old, old_have = (old_library(args.old_csrc, kernels) if args.old_csrc
                     else (None, []))
    with torch.inference_mode():
        time_speech(dev, kernels, old, old_have, args, card)
        for B in (32, 1):
            frames = frames_of(B * 130, dev).reshape(B, 130, 2048)
            x = torch.from_numpy(np.abs(np.random.RandomState(1).randn(
                B, 56, 56, 64)).astype(np.float32)).to(dev, torch.bfloat16)
            cases = []
            if 'k5' in kernels:
                cases += [(f'K5 {prec}', 'k5', lambda prec=prec:
                           dft_kernel.dft_spectrograms(frames, prec),
                           (lambda prec=prec: old_dft(old, frames, prec)))
                          for prec in dft_kernel.PRECISIONS]
            if 'k7' in kernels:
                cases.append(('K7', 'k7',
                              lambda: resnet_kernel.layer1(x, blocks),
                              lambda: old_layer1(old, x, blocks)))
            for name, key, new_fn, old_fn in cases:
                if key not in old_have:
                    print(f'time {name} B={B}: new {cuda_ms(new_fn, args.reps):.4f}'
                          f' ms (median of {args.reps}; {card})')
                    continue
                o1, n1, n2, o2 = (cuda_ms(f, args.reps)
                                  for f in (old_fn, new_fn, new_fn, old_fn))
                print(f'time {name} B={B}: old {statistics.median([o1, o2]):.4f}'
                      f' ms [{o1:.4f}, {o2:.4f}], new '
                      f'{statistics.median([n1, n2]):.4f} ms [{n1:.4f}, '
                      f'{n2:.4f}] (medians of {args.reps}, in turns old, new,'
                      f' new, old; {card})')
        if args.variants:
            variant_times(dev, kernels, args.reps, card)
    if args.trace:
        trace_phases(dev, kernels, card)
    if args.split and 'k5' in kernels:
        split_times(dev, args.reps)
    if args.profile and ('k5' in kernels or 'k7' in kernels):
        from torch.profiler import ProfilerActivity, profile
        for B in (32, 1):
            frames = frames_of(B * 130, dev).reshape(B, 130, 2048)
            x = torch.from_numpy(np.abs(np.random.RandomState(1).randn(
                B, 56, 56, 64)).astype(np.float32)).to(dev, torch.bfloat16)
            with torch.inference_mode(), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    if 'k7' in kernels:
                        resnet_kernel.layer1(x, blocks)
                    for prec in dft_kernel.PRECISIONS if 'k5' in kernels else ():
                        dft_kernel.dft_spectrograms(frames, prec)
                torch.cuda.synchronize()
            by = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by.setdefault(e.name, []).append(e.time_range.elapsed_us())
            for name, us in by.items():
                print(f'profile B={B}: {statistics.median(us):9.1f} us x '
                      f'{len(us) // 5} a call  {name[:100]}')
    print('kernel_ab: ok')


if __name__ == '__main__':
    main()
