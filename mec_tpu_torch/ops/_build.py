"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles in its own nvcc process, all started together, and
one more nvcc call links the objects into a shared library with a plain
C interface, at first use, into mec_tpu_torch/_build/ (git-ignored). The
output name carries a hash of the sources and flags, so an edited kernel
rebuilds and an unchanged one is reused. The library is loaded with
ctypes; each wrapper makes its tensor's card the current device
(device_of), passes tensor pointers and that card's current CUDA stream
as integers and raises on a nonzero cudaError_t.

A failed build raises with nvcc's output. Nothing falls back: a CUDA
tensor reaches its kernel or an exception.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'

# sm_90a (not sm_90): the target that later wgmma/setmaxnreg work needs.
# -Xptxas -v prints each kernel's registers, shared memory and spills
# into the build log.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# streaming multiprocessors of the H100 SXM: the wrappers that pick a tile
# by the problem size want a block for each
SM_COUNT = 132

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds (0.0 when the hashed
# library already existed) and nvcc's combined output
build_info = {'seconds': None, 'log': ''}


def _nvcc() -> str:
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (set NVCC or put the CUDA toolkit '
                       'on PATH); the CUDA kernels cannot be built')


def _sources():
    return sorted(CSRC.glob('*.cu')), sorted(CSRC.glob('*.cuh'))


def build() -> Path:
    """Compile csrc/*.cu into BUILD_DIR (skipped when the hashed output
    exists); returns the library path. Raises with nvcc's output."""
    cu, headers = _sources()
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in cu + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f'libmec_kernels-{h.hexdigest()[:16]}.so'
    if out.exists():
        build_info.update(seconds=0.0, log='')
        return out
    objs = BUILD_DIR / f'obj-{h.hexdigest()[:16]}.{os.getpid()}'
    objs.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.stem}.tmp{os.getpid()}.so')
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = [(p, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-c', '-o', str(objs / f'{p.stem}.o'),
             str(p)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for p in cu]
        logs, failed = [], []
        for p, proc in procs:
            logs.append(f'--- {p.name}\n{proc.communicate()[0]}')
            if proc.returncode != 0:
                failed.append(f'{p.name} (exit {proc.returncode})')
        log = ''.join(logs)
        if failed:
            raise RuntimeError(f'nvcc failed on {", ".join(failed)}:\n{log}')
        link = subprocess.run(
            [nvcc, '-shared', '-o', str(tmp),
             *(str(objs / f'{p.stem}.o') for p in cu)],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(
                f'nvcc link failed (exit {link.returncode}):\n{log}')
        os.replace(tmp, out)   # atomic: no process loads a half-written file
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objs, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, log=log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mec_error_string.argtypes = [ctypes.c_int]
            lib.mec_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_error(err: int, kernel: str) -> None:
    if err != 0:
        msg = library().mec_error_string(err).decode()
        raise RuntimeError(f'{kernel}: CUDA error {err} ({msg})')


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype."""
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: expected a CUDA tensor, got {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: expected a contiguous tensor')


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def device_of(device: torch.device):
    """The context each wrapper's library call runs in: the tensor's card
    is the host thread's current device, so the kernel launches there
    (on its stream) and its attributes are set in that card's context,
    whichever card the caller had current."""
    return torch.cuda.device(device)


_count_lock = threading.Lock()
_capturing = threading.local()


def count_launch(wrapper) -> None:
    """wrapper.launches += 1, safe against concurrent serving threads.
    Inside counting_calls() on this thread (a CUDA graph's capture, which
    launches nothing yet) the call is noted there instead."""
    calls = getattr(_capturing, 'calls', None)
    if calls is not None:
        calls[wrapper] = calls.get(wrapper, 0) + 1
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def counting_calls() -> Iterator[Dict]:
    """Note the wrapper calls this thread makes inside the block, as
    {wrapper: calls}, in place of adding them to .launches: what one
    replay of a graph captured in the block launches (add_launches)."""
    _capturing.calls = calls = {}
    try:
        yield calls
    finally:
        _capturing.calls = None


def add_launches(calls: Dict) -> None:
    """Add counting_calls()'s {wrapper: calls} to the wrappers'
    .launches, under the lock count_launch takes."""
    with _count_lock:
        for wrapper, n in calls.items():
            wrapper.launches += n


def on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the wrapper then runs the plain version);
    False for CUDA; raises for any other device."""
    if t.device.type == 'cpu':
        return True
    if t.device.type == 'cuda':
        return False
    raise ValueError(f'{name}: unsupported device {t.device}')
