"""The port's speech frontend (mec_tpu_torch) against the JAX package.

Same numpy-seeded waveforms through both packages on the CPU. The JAX
side runs its fp32 reference path (audio_features_56 with
use_pallas=False: rFFT STFT, XLA tuning selection, cumsum rolloff); the
port runs its serving branch (hop-slab DFT and the kernels' plain
versions). Tolerances are the JAX package's own for its serving branch
against the reference path (tests/test_pallas.py:60-63): MFCC atol 1e-4,
the other 16 columns rtol 1e-4.

Also pinned here: the numpy-only modules the port copies (filters, wav)
equal their originals, and the port never imports jax.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.ops import audio_features as jaf
from mec_tpu.ops import filters as jfilters
from mec_tpu.ops import wav as jwav
from mec_tpu.serving import wire as jwire
from mec_tpu_torch.ops import audio_features as taf
from mec_tpu_torch.ops import filters as tfilters
from mec_tpu_torch.ops import wav as twav
from mec_tpu_torch.serving import wire as twire

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 66150


def _waves(seed=0):
    """Noise, a two-tone chord and a chirp, each over a noise floor."""
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 22050.0
    return np.stack([
        0.1 * rng.randn(N),
        0.3 * np.sin(2 * np.pi * 261.6 * t) + 0.2 * np.sin(2 * np.pi * 392.0 * t)
        + 0.01 * rng.randn(N),
        0.2 * np.sin(2 * np.pi * (300 + 700 * t) * t) + 0.01 * rng.randn(N),
    ]).astype(np.float32)


@pytest.fixture(scope='module')
def waves():
    return _waves()


@pytest.fixture(scope='module')
def jax_power(waves):
    mag, P = jaf.hop_spectrograms(jnp.asarray(waves))
    return np.asarray(mag), np.asarray(P)


# ----------------------------------------------------------------------
# copied host modules
# ----------------------------------------------------------------------

@pytest.mark.parametrize('name,args', [
    ('hann_window', (2048,)),
    ('fft_frequencies', (22050, 2048)),
    ('mel_filterbank', (22050, 2048, 128)),
    ('dct_matrix', (40, 128)),
    ('chroma_base_bins', (22050, 2048, 12)),
])
def test_filters_tables_equal_original(name, args):
    got = getattr(tfilters, name)(*args)
    ref = getattr(jfilters, name)(*args)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_wav_copy_round_trip_equals_original(tmp_path, waves):
    y = waves[1] * 0.9
    p_port, p_ref = str(tmp_path / 'port.wav'), str(tmp_path / 'ref.wav')
    twav.write_wav(p_port, y, 22050)
    jwav.write_wav(p_ref, y, 22050)
    with open(p_port, 'rb') as a, open(p_ref, 'rb') as b:
        assert a.read() == b.read()
    got, sr = twav.load_and_fix_length(p_port)
    ref, _ = jwav.load_and_fix_length(p_ref)
    assert sr == 22050 and got.shape == (N,)
    np.testing.assert_array_equal(got, ref)
    # resampling path (scipy polyphase) and the short-clip zero pad
    twav.write_wav(p_port, y[:30000], 16000)
    np.testing.assert_array_equal(twav.load_and_fix_length(p_port)[0],
                                  jwav.load_and_fix_length(p_port)[0])


def test_port_never_imports_jax():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|flax|optax|msgpack)\b',
                         re.MULTILINE)
    hits = []
    for root, _dirs, files in os.walk(os.path.join(_REPO, 'mec_tpu_torch')):
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(root, f)
                with open(path, encoding='utf-8') as fh:
                    if pattern.search(fh.read()):
                        hits.append(os.path.relpath(path, _REPO))
    with open(os.path.join(_REPO, 'chip_smoke.py'), encoding='utf-8') as fh:
        smoke = fh.read()
    if pattern.search(smoke) or re.search(r'\bmec_tpu\.', smoke):
        hits.append('chip_smoke.py')
    assert hits == []


_BLOCKER = '''
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BLOCKED:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import mec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mec_tpu_torch.__path__,
                                               'mec_tpu_torch.')]
'''


def test_port_imports_without_jax_flax_msgpack_werkzeug():
    """Every module of the port imports in a process where jax, flax,
    optax, msgpack and werkzeug cannot be imported, nor the reference's
    checkpoint readers (sklearn, joblib, h5py, safetensors), nor cv2
    (preprocessing/image_preprocessing.py imports it at its call): the
    trainers import sklearn and joblib only when train_fusion_rf trains,
    the converters theirs only when a conversion runs. The web app
    (mec_tpu_torch.webapp.*) needs werkzeug, which the card's machine
    has: a second process imports it with werkzeug allowed and the rest
    blocked, and without jinja2 being imported (the HTML pages import
    it at their first render)."""
    blocked = ('jax', 'flax', 'optax', 'msgpack', 'mec_tpu', 'sklearn',
               'h5py', 'safetensors', 'joblib', 'cv2')
    code = (f'BLOCKED = {blocked + ("werkzeug",)!r}' + _BLOCKER + '''
names = [n for n in names if not n.startswith('mec_tpu_torch.webapp')]
for n in names:
    importlib.import_module(n)
print(' '.join(names))
''')
    out = subprocess.run([sys.executable, '-c', code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 60
    # the native host runtime, the host features and the facade too
    assert {f'mec_tpu_torch.{m}' for m in (
        'native', 'native.build', 'native.featurizer', 'native.tokenizer',
        'ops.host_features', 'preprocessing',
        'preprocessing.audio_preprocessing',
        'preprocessing.text_preprocessing',
        'preprocessing.image_preprocessing')} <= set(names)
    code = f'BLOCKED = {blocked!r}' + _BLOCKER + '''
names = [n for n in names if n.startswith('mec_tpu_torch.webapp.')]
for n in names:
    importlib.import_module(n)
assert 'jinja2' not in sys.modules
print(' '.join(sorted(names)))
'''
    out = subprocess.run([sys.executable, '-c', code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [f'mec_tpu_torch.webapp.{m}' for m in
                                  ('app', 'ratelimit', 'serve', 'sessions')]


# ----------------------------------------------------------------------
# wire
# ----------------------------------------------------------------------

def test_pcm12_encode_and_decode_exact(waves):
    packed, scale = twire.encode_pcm12_np(waves)
    r_packed, r_scale = jwire.encode_pcm12_np(waves)
    np.testing.assert_array_equal(packed, r_packed)
    np.testing.assert_array_equal(scale, r_scale)
    got = twire.decode_pcm12(torch.from_numpy(packed),
                             torch.from_numpy(scale)).numpy()
    ref = np.asarray(jwire.decode_pcm12(jnp.asarray(packed),
                                        jnp.asarray(scale)))
    assert got.dtype == np.float32 and got.shape == waves.shape
    np.testing.assert_array_equal(got, ref)


# ----------------------------------------------------------------------
# frontend stages
# ----------------------------------------------------------------------

def test_hop_spectrograms_match_jax(waves, jax_power):
    """Same hop-slab algorithm, fp32 matmuls on both sides: rtol 1e-4,
    with an atol at 1e-7 of the spectrum's peak for bins whose power
    cancels to ~0 (where a relative bound has no meaning)."""
    mag, P = taf.hop_spectrograms(torch.from_numpy(waves))
    rmag, rP = jax_power
    assert P.shape == (3, 130, 1025)
    np.testing.assert_allclose(P.numpy(), rP, rtol=1e-4,
                               atol=1e-7 * rP.max())
    np.testing.assert_allclose(mag.numpy(), rmag, rtol=1e-4,
                               atol=1e-7 * rmag.max())


def test_zcr_and_rms_match_jax(waves):
    y = torch.from_numpy(waves)
    np.testing.assert_array_equal(
        taf.zcr_mean_hops(y).numpy(),
        np.asarray(jaf.zcr_mean_hops(jnp.asarray(waves))))
    np.testing.assert_allclose(
        taf.rms_mean_hops(y).numpy(),
        np.asarray(jaf.rms_mean_hops(jnp.asarray(waves))), rtol=1e-6)


def test_tuning_estimate_matches_jax_exactly(jax_power):
    """Candidate prep, log2 residual fold and selection, from the same
    power spectrogram: the tuning value is bit-equal."""
    _mag, P = jax_power
    ref = np.asarray(jaf.estimate_tuning_from_power(jnp.asarray(P),
                                                    use_pallas=False))
    got = taf.estimate_tuning_from_power(torch.from_numpy(P)).numpy()
    np.testing.assert_array_equal(got, ref)
    silent = np.zeros((1, 130, 1025), np.float32)
    assert taf.estimate_tuning_from_power(torch.from_numpy(silent))[0] == 0


def test_chroma_filterbank_matches_jax():
    tuning = np.array([0.0, -0.23, 0.41], np.float32)
    got = taf.chroma_filterbank(torch.from_numpy(tuning)).numpy()
    ref = np.asarray(jaf.chroma_filterbank(jnp.asarray(tuning)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_spectral_stats_match_jax(jax_power):
    mag, _P = jax_power
    got_c = taf.spectral_centroid_mean(torch.from_numpy(mag)).numpy()
    ref_c = np.asarray(jaf.spectral_centroid_mean(jnp.asarray(mag)))
    np.testing.assert_allclose(got_c, ref_c, rtol=1e-5)
    got_r = taf.spectral_rolloff_mean(torch.from_numpy(mag)).numpy()
    ref_r = np.asarray(jaf.spectral_rolloff_mean(jnp.asarray(mag)))
    np.testing.assert_allclose(got_r, ref_r, rtol=1e-6)


def test_audio_features_56_matches_jax_reference(waves):
    """The whole serving frontend at B=2 against the JAX fp32 reference
    path (rFFT STFT, XLA tuning, cumsum rolloff)."""
    y = waves[:2]
    ref = np.asarray(jaf.audio_features_56(jnp.asarray(y), use_pallas=False))
    got = taf.audio_features_56(torch.from_numpy(y)).numpy()
    assert got.shape == (2, 56) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, :40], ref[:, :40], atol=1e-4)
    np.testing.assert_allclose(got[:, 40:], ref[:, 40:], rtol=1e-4)


def test_spectral_features_4_matches_jax(waves):
    got = taf.spectral_features_4(torch.from_numpy(waves)).numpy()
    ref = np.asarray(jaf.spectral_features_4(jnp.asarray(waves)))
    np.testing.assert_allclose(got, ref, rtol=1e-4)
