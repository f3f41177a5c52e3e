"""Build the native host libraries with g++ and load them with ctypes.

A copy of mec_tpu/native/build.py::load_library (the same g++ flags and
the same cache key: the source, the flags and the host CPU's feature
set), with the port's failure rules: a source that g++ rejects raises
with g++'s output (a repository source that does not compile is a bug),
and only a host with no g++ on PATH returns None, after one warning, so
the caller takes its numpy or Python version. The libraries build into
mec_tpu_torch/_build/native/ (git-ignored), or MEC_NATIVE_BUILD_DIR,
under a temporary name that is then renamed into place, so processes
building at the same time never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

log = logging.getLogger('mec_tpu_torch.native')

_HERE = Path(__file__).resolve().parent
NAMES = ('wirecodec', 'wordpiece', 'audiofeat')

# -ffp-contract=off: the wire codecs pin float32 numerics against their
# numpy versions; FMA contraction would reassociate those expressions.
# -O3 for auto-vectorization of the featurizer's FFT and filter loops
# (IEEE semantics kept: no -ffast-math). -fno-math-errno lets the libm
# calls (nearbyintf, sqrtf, ...) vectorize; nobody reads errno.
# -march=native: the x86-64 baseline is SSE2 only, which blocks float
# vectorization (roundps needs SSE4.1); the CPU fingerprint in the cache
# key keeps a binary from being loaded on a host with other features.
FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-std=c++17',
         '-ffp-contract=off', '-fno-math-errno', '-pthread')

_lock = threading.Lock()
_cache: Dict[str, Optional[ctypes.CDLL]] = {}
_warned = False


def build_dir() -> Path:
    d = os.environ.get('MEC_NATIVE_BUILD_DIR')
    return Path(d) if d else _HERE.parent / '_build' / 'native'


def _cpu_fingerprint() -> bytes:
    """The machine and its ISA flags (x86 'flags', arm64 'Features'):
    -march=native code is specific to them, and a build directory copied
    to another host must not load a binary built for other features
    (SIGILL)."""
    parts = [platform.machine()]
    try:
        with open('/proc/cpuinfo', encoding='utf-8', errors='replace') as f:
            for line in f:
                if line.startswith(('flags', 'Features')):
                    parts.append(' '.join(sorted(
                        line.split(':', 1)[1].split())))
                    break
    except OSError:
        pass
    return '|'.join(parts).encode()


def library_path(name: str) -> Path:
    """Where the library of `name`.cpp lives for this source, these
    flags and this host's CPU features."""
    digest = hashlib.sha256((_HERE / f'{name}.cpp').read_bytes()
                            + ' '.join(FLAGS).encode()
                            + _cpu_fingerprint()).hexdigest()[:16]
    return build_dir() / f'lib{name}-{digest}.so'


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """mec_tpu_torch/native/<name>.cpp built (once per source, flags and
    CPU) and loaded; None when g++ is not on PATH. A failed compile
    raises RuntimeError with g++'s stderr."""
    global _warned
    with _lock:
        if name in _cache:
            return _cache[name]
        so = library_path(name)
        if not so.exists():
            gxx = shutil.which('g++')
            if gxx is None:
                if not _warned:
                    log.warning('g++ is not on PATH: the native host '
                                'libraries (%s) are not built; the numpy '
                                'and Python versions run instead',
                                ', '.join(NAMES))
                    _warned = True
                _cache[name] = None
                return None
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f'{so.stem}.tmp{os.getpid()}.so')
            try:
                out = subprocess.run(
                    [gxx, *FLAGS, str(_HERE / f'{name}.cpp'), '-o', str(tmp)],
                    capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(
                        f'g++ failed on mec_tpu_torch/native/{name}.cpp '
                        f'(exit {out.returncode}):\n{out.stderr}')
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
        _cache[name] = ctypes.CDLL(str(so))
        return _cache[name]


def status() -> Dict[str, bool]:
    """For each native library, whether it loaded (False: the numpy or
    Python version runs); builds the ones not built yet."""
    from mec_tpu_torch.native import featurizer
    return {'wirecodec': load_library('wirecodec') is not None,
            'wordpiece': load_library('wordpiece') is not None,
            'audiofeat': featurizer.have_native()}
