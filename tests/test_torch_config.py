"""The port's configuration against mec_tpu.config: the .env loader, the
web keys, and the flags that switch its kernels and host features (C13).

Tolerances, each with its reason:

* .env, Config values and which kernel wrappers a dispatch calls: equal;
* MEC_USE_PALLAS=0 in bf16, against the JAX bf16 engine (whose CPU graph
  is its non-Pallas one) on the same pcm12 wire: the 56 features within
  1e-4 (+ 2e-6 relative, tests/test_torch_parity.py's contract: the same
  rFFT parity graph on both sides); probabilities within 0.05, the bf16
  band of tests/test_quant.py, with decisions equal wherever the JAX
  top-2 margin exceeds that band: the JAX DNN runs in bf16 and the port's
  plain SpeechDNN in fp32.
"""

import json
import logging
import os
import subprocess
import sys
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu import config as jconfig
from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert import store as jstore
from mec_tpu.ops import audio_features as jaf
from mec_tpu.serving import wire as jwire
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu_torch import config as tconfig
from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import audio_features as taf
from mec_tpu_torch.ops import speech_kernels
from mec_tpu_torch.serving import wire
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import speech_variables

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 66150
BAND = 0.05


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tier-1 run has six workers on the CPU: torch's default of one
    thread a core in each of them makes them spin on each other, so this
    file keeps torch at two threads and restores the count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

DOTENV = '''# a comment line
export MEC_COMPUTE_DTYPE=bfloat16
SECRET_KEY="quoted value # not a comment"
UPLOAD_FOLDER='single quoted'
MEC_BATCH_BUCKETS=1,8,32   # trailing comment
MEC_LOG_DIR=logs\t#tab comment
EXISTING=from the file

NO_EQUALS_SIGN
=no key
EMPTY=
SPACED = around the sign
'''

# every Config key the web app, the database and the switches read
WEB_KEYS = ('SECRET_KEY', 'WTF_CSRF_ENABLED', 'WTF_CSRF_TIME_LIMIT',
            'FORCE_HTTPS', 'SESSION_COOKIE_SECURE', 'SESSION_COOKIE_HTTPONLY',
            'SESSION_COOKIE_SAMESITE', 'PERMANENT_SESSION_LIFETIME',
            'SESSION_REFRESH_EACH_REQUEST', 'SECURITY_HEADERS',
            'DATABASE_PATH', 'SQLALCHEMY_DATABASE_URI', 'UPLOAD_FOLDER',
            'MAX_FILE_SIZE', 'ALLOWED_AUDIO_EXTENSIONS',
            'ALLOWED_IMAGE_EXTENSIONS', 'RATELIMIT_ENABLED', 'USE_PALLAS',
            'PALLAS_TUNING', 'PALLAS_ROLLOFF', 'HOST_AUDIO_FEATURES',
            'LOG_DIR')
ENVS = {
    'defaults': {},
    'set': {'FLASK_ENV': 'production', 'SECRET_KEY': 's3cret',
            'DATABASE_URL': 'sqlite:////tmp/mec_cfg_test.db',
            'UPLOAD_FOLDER': '/tmp/mec_uploads', 'MEC_RATELIMIT': '0',
            'MEC_USE_PALLAS': '0', 'MEC_PALLAS_TUNING': 'off',
            'MEC_PALLAS_ROLLOFF': 'yes', 'MEC_HOST_AUDIO_FEATURES': '1',
            'MEC_LOG_DIR': '/tmp/mec_logs'},
}
_CONFIG_VARS = ('FLASK_ENV', 'SECRET_KEY', 'DATABASE_URL', 'UPLOAD_FOLDER',
                'MEC_RATELIMIT', 'MEC_USE_PALLAS', 'MEC_PALLAS_TUNING',
                'MEC_PALLAS_ROLLOFF', 'MEC_HOST_AUDIO_FEATURES', 'MEC_LOG_DIR',
                'MEC_COMPUTE_DTYPE')


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in _CONFIG_VARS}
    env['PYTHONPATH'] = _REPO
    env.update(extra)
    return env


# ----------------------------------------------------------------------
# .env
# ----------------------------------------------------------------------

def test_load_dotenv_matches_jax(tmp_path):
    path = tmp_path / '.env'
    path.write_text(DOTENV, encoding='utf-8')
    base = {'EXISTING': 'from the environment', 'PATH': '/bin'}
    results = []
    for load in (jconfig.load_dotenv, tconfig.load_dotenv):
        with mock.patch.dict(os.environ, base, clear=True):
            assert load(str(path)) is True
            results.append(dict(os.environ))
    assert results[0] == results[1]
    got = results[1]
    assert got['EXISTING'] == 'from the environment'
    assert got['MEC_COMPUTE_DTYPE'] == 'bfloat16'
    assert got['SECRET_KEY'] == 'quoted value # not a comment'
    assert got['MEC_BATCH_BUCKETS'] == '1,8,32'
    assert got['MEC_LOG_DIR'] == 'logs'
    assert 'NO_EQUALS_SIGN' not in got
    for load in (jconfig.load_dotenv, tconfig.load_dotenv):
        assert load(str(tmp_path / 'absent.env')) is False


@pytest.mark.parametrize('case,want', [('loads', 'bfloat16'),
                                       ('skip_flag', 'float32'),
                                       ('under_pytest', 'float32')])
def test_dotenv_at_import_and_its_opt_outs(tmp_path, case, want):
    """A fresh interpreter in a directory with a .env: importing the
    port's config loads it, unless MEC_SKIP_DOTENV=1 or pytest is
    imported (the JAX package's two opt-outs)."""
    (tmp_path / '.env').write_text('MEC_COMPUTE_DTYPE=bfloat16\n')
    pre = "import sys; sys.modules['pytest'] = None; " \
        if case == 'under_pytest' else ''
    env = _clean_env()
    env.pop('MEC_SKIP_DOTENV', None)
    if case == 'skip_flag':
        env['MEC_SKIP_DOTENV'] = '1'
    out = subprocess.run(
        [sys.executable, '-c', pre + 'from mec_tpu_torch.config import '
         'Config; print(Config.COMPUTE_DTYPE)'],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == want


# ----------------------------------------------------------------------
# the Config keys, under the same environment
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def configs():
    """Both Config classes imported in fresh interpreters under each
    environment: {env: {key: [equal, jax repr, port repr]}}."""
    code = '''
import json, sys
from mec_tpu.config import Config as J
from mec_tpu_torch.config import Config as T
print(json.dumps({k: [getattr(J, k) == getattr(T, k), repr(getattr(J, k)),
                      repr(getattr(T, k))] for k in sys.argv[1:]}))
'''
    out = {}
    for name, extra in ENVS.items():
        r = subprocess.run(
            [sys.executable, '-c', code, *WEB_KEYS], cwd=_REPO,
            env=_clean_env(MEC_SKIP_DOTENV='1', JAX_PLATFORMS='cpu',
                           **extra),
            capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        out[name] = json.loads(r.stdout.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize('key', WEB_KEYS)
@pytest.mark.parametrize('env', sorted(ENVS))
def test_config_key_matches_jax(configs, env, key):
    equal, jax_repr, port_repr = configs[env][key]
    assert equal, (jax_repr, port_repr)


def test_environment_reaches_the_keys(configs):
    """The 'set' environment changes what it names (so the comparison
    above is not of two defaults)."""
    for key, want in (('FORCE_HTTPS', 'True'), ('SECRET_KEY', "'s3cret'"),
                      ('RATELIMIT_ENABLED', 'False'),
                      ('USE_PALLAS', 'False'), ('PALLAS_TUNING', 'False'),
                      ('HOST_AUDIO_FEATURES', "'1'"),
                      ('SQLALCHEMY_DATABASE_URI',
                       "'sqlite:////tmp/mec_cfg_test.db'")):
        assert configs['set'][key][2] == want, key
        assert configs['defaults'][key][2] != want, key


# ----------------------------------------------------------------------
# the kernel switches and host features
# ----------------------------------------------------------------------

def _clips(B=4, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 22050.0
    rows = []
    for i in range(B):
        if i % 3 == 0:
            y = 0.3 * np.sin(2 * np.pi * (180 + 90 * i) * t)
        elif i % 3 == 1:
            y = 0.2 * np.sin(2 * np.pi * (200 + 250 * t * (i + 1)) * t)
        else:
            y = 0.05 * (i + 1) * rng.randn(N)
        rows.append(y + 0.01 * rng.randn(N))
    return np.stack(rows).astype(np.float32)


@pytest.fixture(scope='module')
def speech():
    """A speech tree and a scaler fitted on its clips' parity features
    (so the logits are not saturated)."""
    tree = speech_variables(seed=3)
    feats = taf.audio_features_56(torch.from_numpy(_clips(8, 1)),
                                  'parity').numpy()
    return tree, (feats.mean(axis=0).astype(np.float32),
                  (feats.std(axis=0) + 1e-3).astype(np.float32))


WRAPPERS = ('mfcc_mean', 'tuning_select', 'tuning_select_plain',
            'rolloff_bins', 'dft_spectrograms', 'speech_dnn')


@pytest.fixture()
def calls(monkeypatch):
    """Counts of the kernel wrappers the speech step calls (on the CPU
    each runs its plain version; on the card each call is a launch)."""
    counts = dict.fromkeys(WRAPPERS, 0)
    for name in WRAPPERS:
        mod = speech_kernels if name == 'speech_dnn' else taf
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return counts


@pytest.mark.parametrize('dtype,flags,prec,off,want', [
    ('bfloat16', {}, 'high', '',
     dict(mfcc_mean=1, tuning_select=1, rolloff_bins=1, speech_dnn=1)),
    ('bfloat16', {}, 'highest', '',
     dict(mfcc_mean=1, tuning_select=1, rolloff_bins=1, speech_dnn=1,
          dft_spectrograms=1)),
    ('bfloat16', {'USE_PALLAS': False}, 'highest',
     'K1 mfcc_mean, K3 rolloff_bins, K4 speech_dnn, K5 dft_spectrograms',
     dict(tuning_select=1)),
    ('bfloat16', {'PALLAS_TUNING': False}, 'high', 'K2 tuning_select',
     dict(mfcc_mean=1, tuning_select_plain=1, rolloff_bins=1,
          speech_dnn=1)),
    ('bfloat16', {'PALLAS_ROLLOFF': False}, 'high', 'K3 rolloff_bins',
     dict(mfcc_mean=1, tuning_select=1, speech_dnn=1)),
    ('float32', {}, 'high', '', dict(tuning_select=1)),
    ('float32', {'PALLAS_TUNING': False}, 'high', 'K2 tuning_select',
     dict(tuning_select_plain=1)),
    ('float32', {'USE_PALLAS': False, 'PALLAS_ROLLOFF': False}, 'high', '',
     dict(tuning_select=1)),
])
def test_switches_turn_off_the_jax_kernels(speech, calls, monkeypatch,
                                           caplog, dtype, flags, prec, off,
                                           want):
    """MEC_USE_PALLAS, MEC_PALLAS_TUNING and MEC_PALLAS_ROLLOFF turn off
    the kernels the JAX package's switches turn off, and only those: the
    wrappers one speech dispatch calls, and the one line the engine logs
    at build. (The waveform graph: the host audio features, which 'auto'
    turns on with >= 4 CPUs and g++, are pinned off.)"""
    monkeypatch.setattr(Config, 'HOST_AUDIO_FEATURES', '0')
    for k, v in flags.items():
        monkeypatch.setattr(Config, k, v)
    monkeypatch.setattr(Config, 'DFT_PRECISION', prec)
    with caplog.at_level(logging.WARNING, logger='mec_tpu_torch.serving'):
        eng = EmotionEngine(*speech, compute_dtype=dtype, device='cpu')
    lines = [r.getMessage() for r in caplog.records
             if 'turned off' in r.getMessage()]
    assert lines == ([f'kernels turned off by MEC_USE_PALLAS, '
                      f'MEC_PALLAS_TUNING or MEC_PALLAS_ROLLOFF: {off}']
                     if off else [])
    for k in calls:
        calls[k] = 0
    eng.predict_speech_waves(_clips(2))
    assert calls == {**dict.fromkeys(WRAPPERS, 0), **want}


@pytest.fixture(scope='module')
def jax_bf16(speech, tmp_path_factory):
    d = tmp_path_factory.mktemp('models')
    tree, (mean, scale) = speech
    jstore.save_params(str(d / 'speech_model.mecp'), tree)
    np.savez(str(d / 'speech_scaler.npz'), mean=mean, scale=scale)
    # the waveform wire and the on-device graph (its 'auto' host
    # featurizer would take the features on this multi-core host)
    old = JaxConfig.COMPUTE_DTYPE, JaxConfig.HOST_AUDIO_FEATURES
    JaxConfig.COMPUTE_DTYPE, JaxConfig.HOST_AUDIO_FEATURES = 'bfloat16', '0'
    try:
        eng = JaxEngine(models_dir=str(d), mesh=None)
    finally:
        JaxConfig.COMPUTE_DTYPE, JaxConfig.HOST_AUDIO_FEATURES = old
    assert eng.speech is not None and not eng._host_audio
    return eng


def test_use_pallas_off_is_the_jax_non_pallas_graph(speech, jax_bf16,
                                                    monkeypatch):
    """MEC_USE_PALLAS=0 in bf16: both engines ship the pcm12 wire and run
    the rFFT graph (the JAX engine's use_pallas=False, which is also its
    CPU graph); the port's DNN is the plain SpeechDNN."""
    monkeypatch.setattr(Config, 'USE_PALLAS', False)
    port = EmotionEngine(*speech, compute_dtype='bfloat16', device='cpu')
    assert port._dft_precision == 'parity' and port._compress
    assert not hasattr(port.speech['dnn'], 'params')     # not K4's forward
    clips = _clips(6, 2)
    packed, scl = wire.encode_pcm12_np(clips)
    j_packed, j_scl = jwire.encode_pcm12_np(clips)
    np.testing.assert_array_equal(packed, j_packed)
    got = taf.audio_features_56(
        wire.decode_pcm12(torch.from_numpy(packed), torch.from_numpy(scl)),
        port._dft_precision).numpy()
    want = np.asarray(jaf.audio_features_56(
        jwire.decode_pcm12(jnp.asarray(j_packed), jnp.asarray(j_scl)),
        use_pallas=False))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=2e-6)
    ref = jax_bf16.predict_speech_waves(clips)
    res = port.predict_speech_waves(clips)
    compared = 0
    for g, r in zip(res, ref):
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=BAND)
        top2 = np.sort(r['all_probabilities'])[-2:]
        if top2[1] - top2[0] > BAND:
            assert g['emotion'] == r['emotion']
            compared += 1
    assert compared >= 3


@pytest.mark.parametrize('value,dtype,cpus,outcome', [
    ('1', 'bfloat16', 8, 'features'),
    ('on', 'bfloat16', 2, 'features'),
    ('1', 'float32', 8, 'waveform'),
    ('auto', 'bfloat16', 8, 'features'),
    ('auto', 'bfloat16', 2, 'waveform'),
    ('auto', 'float32', 8, 'waveform'),
    ('0', 'bfloat16', 8, 'waveform')])
def test_host_audio_features(speech, calls, monkeypatch, caplog, value,
                             dtype, cpus, outcome):
    """MEC_HOST_AUDIO_FEATURES resolved as the JAX engine resolves it
    (engine.py:128-146): an explicit on value featurizes in bf16 whatever
    the CPU count; 'auto' featurizes in bf16 with >= 4 CPUs and the C++
    featurizer built; fp32 ships the waveform. The engine logs its audio
    wire once at build; a featurizing dispatch calls the DNN wrapper (K4)
    and no frontend wrapper."""
    from mec_tpu_torch.native import featurizer
    if value == 'auto' and outcome == 'features' \
            and not featurizer.have_native():
        pytest.skip("g++ is not on PATH: 'auto' keeps the waveform here")
    monkeypatch.setattr(Config, 'HOST_AUDIO_FEATURES', value)
    monkeypatch.setattr(os, 'cpu_count', lambda: cpus)
    with caplog.at_level(logging.INFO, logger='mec_tpu_torch.serving'):
        eng = EmotionEngine(*speech, compute_dtype=dtype, device='cpu')
    said = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith('speech wire: ')]
    assert len(said) == 1
    assert said[0].startswith('speech wire: host features' if outcome ==
                              'features' else 'speech wire: waveform')
    assert eng._host_audio == (outcome == 'features')
    wire_arrays = eng._wire_waves(_clips(1), 1)
    for k in calls:
        calls[k] = 0
    eng.predict_speech_waves(_clips(2))
    if outcome == 'features':
        assert [a.shape for a in wire_arrays] == [(1, 56)]
        assert calls == {**dict.fromkeys(WRAPPERS, 0), 'speech_dnn': 1}
    else:
        assert len(wire_arrays[0][0]) != 56                # the waveform
        assert calls['tuning_select'] == 1
