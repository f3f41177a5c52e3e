#!/usr/bin/env python3
"""K5 (dft_power) and K7 (layer1_int8) on one NVIDIA GPU: build report,
checks against the plain versions, and times, optionally in turns with
an older build of the two sources.

    python3 -m mec_tpu_torch.bench.kernel_ab [--old-csrc DIR] [--reps N]
                                              [--profile] [--split]

* build: what ptxas reports for the two sources (registers, spills,
  shared memory) and, where the toolkit has cuobjdump, how many
  tensor-core instructions the built library holds per kernel (HMMA for
  K5 'bf16', IMMA for K7's convs).
* check: K5 at B*T in {1, 130, 131, 4160} in both precisions against the
  plain version (mag atol 5e-5, P relative 5e-3, the JAX package's
  contract) and, for reference, both against fp64 sums of the same
  operands;
  K7 torch.equal against the plain version at B in {1, 2, 32} and an odd
  map.
* time: CUDA-event medians at B = 32 (and B = 1). With --old-csrc, a
  directory that holds an earlier dft_power.cu and layer1_int8.cu (for
  example `git show <commit>:mec_tpu_torch/csrc/dft_power.cu`), those
  are built into a library of their own and timed in turns old, new,
  new, old. The older sources must have the interface of the first
  version of these kernels (one fp32 table layout for K5; six scratch
  maps for K7).

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
from mec_tpu_torch.serving.synthetic_artifacts import layer1_quant_params

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


def build_report():
    _build.library()
    log = _build.build_info['log']
    lib_path = _build.build()     # the hashed library now exists: its path
    keep = False
    for line in log.splitlines():
        if line.startswith('--- '):
            keep = line.split()[1] in ('dft_power.cu', 'layer1_int8.cu')
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
                   'LDGSTS'):
            if name and f' {op}' in line:
                counts.setdefault(name, {}).setdefault(op, 0)
                counts[name][op] += 1
    for name, ops in counts.items():
        if 'dft_power' in name or 'conv' in name:
            print(f'sass: {name[:100]}: {ops}')


def old_library(csrc):
    """Build DIR's dft_power.cu and layer1_int8.cu into a library of
    their own (the first version's C interface)."""
    out = Path(tempfile.mkdtemp(prefix='kernel_ab_')) / 'libold.so'
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS[:-2], '-shared', '-o', str(out),
           str(Path(csrc) / 'dft_power.cu'), str(Path(csrc) / 'layer1_int8.cu')]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode:
        sys.exit(f'old build failed:\n{run.stdout}{run.stderr}')
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    ptrs = P * 10
    lib.mec_dft_power.argtypes = [P, P, P, I, I, I, I, P, P, P]
    lib.mec_layer1_int8.argtypes = [P, I, I, I, ptrs, ptrs, ptrs, P,
                                    P, P, P, P, P, P, P, P]
    return lib


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--old-csrc', help='directory with an earlier '
                    'dft_power.cu and layer1_int8.cu to time in turns')
    ap.add_argument('--reps', type=int, default=30)
    ap.add_argument('--split', action='store_true', help="K5's time as a "
                    'line in the contraction length (loop against epilogue)')
    ap.add_argument('--profile', action='store_true', help='device time '
                    'of each launch at B=32 (torch.profiler)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('kernel_ab: needs an NVIDIA GPU')
    dev = torch.device('cuda')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f'card: {card} | torch {torch.__version__}')
    build_report()
    ok = True

    # ------------------------------------------------------- K5 checks
    # the fp64 reference takes the operands the precision takes (for
    # 'bf16' the rounded frames and tables), so it shows what the fp32
    # summation alone costs each version
    for m in (1, 130, 131, 4160):
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
    blocks = layer1_blocks(dev)
    for shape in ((1, 56, 56, 64), (2, 56, 56, 64), (32, 56, 56, 64),
                  (2, 13, 9, 64), (3, 57, 55, 64)):
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
    old = old_library(args.old_csrc) if args.old_csrc else None
    with torch.inference_mode():
        for B in (32, 1):
            frames = frames_of(B * 130, dev).reshape(B, 130, 2048)
            x = torch.from_numpy(np.abs(np.random.RandomState(1).randn(
                B, 56, 56, 64)).astype(np.float32)).to(dev, torch.bfloat16)
            cases = [(f'K5 {prec}',
                      lambda prec=prec: dft_kernel.dft_spectrograms(frames, prec),
                      (lambda prec=prec: old_dft(old, frames, prec)))
                     for prec in dft_kernel.PRECISIONS]
            cases.append(('K7', lambda: resnet_kernel.layer1(x, blocks),
                          lambda: old_layer1(old, x, blocks)))
            for name, new_fn, old_fn in cases:
                if old is None:
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
    if args.split:
        split_times(dev, args.reps)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        for B in (32, 1):
            frames = frames_of(B * 130, dev).reshape(B, 130, 2048)
            x = torch.from_numpy(np.abs(np.random.RandomState(1).randn(
                B, 56, 56, 64)).astype(np.float32)).to(dev, torch.bfloat16)
            with torch.inference_mode(), profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    resnet_kernel.layer1(x, blocks)
                    for prec in dft_kernel.PRECISIONS:
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
