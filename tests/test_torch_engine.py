"""The port's speech serving slice (mec_tpu_torch) against the JAX engine.

Both engines get the same parameters: a full-width SpeechDNN tree made
from a numpy seed, and one scaler. The JAX EmotionEngine reads them from
a models/ directory holding only speech_model.mecp and
speech_scaler.npz, in fp32 parity mode on the CPU; the port's engine
takes the numpy tree directly and runs on device='cpu' (the kernels'
plain versions). Both are fed the same raw waveforms: in fp32 parity
mode both ship float32 samples (the 12-bit and PCM16 wires are bf16
serving formats). Decisions must be equal, probabilities and the 64-dim
penultimate within 1e-4.

Also here: the port's engine drops into the unchanged web app, the
copied config/batcher/StageTimer match their originals, and the
engine's fallbacks.
"""

import io
import os
import re
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert import store
from mec_tpu.serving import wire as jwire
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import audio_features as taf
from mec_tpu_torch.ops import wav as twav
from mec_tpu_torch.serving import wire as twire
from mec_tpu_torch.serving.batcher import EngineBatcher
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import speech_variables

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 66150


def _waves():
    rng = np.random.RandomState(7)
    t = np.arange(N) / 22050.0
    return np.stack([
        0.1 * rng.randn(N),
        0.3 * np.sin(2 * np.pi * 261.6 * t) + 0.2 * np.sin(2 * np.pi * 392 * t)
        + 0.01 * rng.randn(N),
        0.2 * np.sin(2 * np.pi * (300 + 700 * t) * t) + 0.01 * rng.randn(N),
        0.01 * rng.randn(N),
        0.6 * np.sin(2 * np.pi * 880 * t) * (1 + np.sin(2 * np.pi * 3 * t))
        / 2 + 0.05 * rng.randn(N),
    ]).astype(np.float32)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """One JAX engine and one port engine over the same parameters."""
    waves = _waves()
    tree = speech_variables(seed=2)
    feats = taf.audio_features_56(torch.from_numpy(waves)).numpy()
    mean = feats.mean(axis=0).astype(np.float32)
    scale = (feats.std(axis=0) + 1e-3).astype(np.float32)
    models = tmp_path_factory.mktemp('models')
    store.save_params(str(models / 'speech_model.mecp'), tree)
    np.savez(str(models / 'speech_scaler.npz'), mean=mean, scale=scale)
    jax_engine = JaxEngine(models_dir=str(models), mesh=None)
    assert jax_engine.speech is not None and jax_engine.bert is None
    port = EmotionEngine(tree, (mean, scale), device='cpu')
    return {'waves': waves, 'tree': tree, 'scaler': (mean, scale),
            'jax': jax_engine, 'port': port}


def _wire_samples(waves):
    packed, scale = jwire.encode_pcm12_np(waves)
    return np.asarray(jwire.decode_pcm12(jnp.asarray(packed),
                                         jnp.asarray(scale)))


def _wav_path(tmp_path, name, y):
    path = str(tmp_path / name)
    twav.write_wav(path, y, 22050)
    return path


# ----------------------------------------------------------------------
# the slice as a whole
# ----------------------------------------------------------------------

def test_engine_matches_jax_engine(setup):
    """Same raw waveforms into both fp32 engines: the port's wire must
    not quantize what the JAX parity engine ships as float32."""
    waves = setup['waves']
    assert setup['port']._wire_waves(waves, 8)[0].dtype == np.float32
    ref = setup['jax'].predict_speech_waves(waves, want_features=True)
    got = setup['port'].predict_speech_waves(waves, want_features=True)
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        p = np.sort(r['all_probabilities'])
        assert p[-1] - p[-2] > 1e-3          # no near-tie: decisions stable
        assert g['emotion'] == r['emotion']
        assert '_fallback' not in g
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=1e-4)
        np.testing.assert_allclose(g['_features'], r['_features'], atol=1e-4)
        assert g['_features'].shape == (64,)
        assert abs(sum(g['all_probabilities']) - 1.0) < 1e-5
    assert len({g['emotion'] for g in got}) > 1   # the weights discriminate


def test_engine_buckets_and_paths(setup, tmp_path):
    port = setup['port']
    assert [port._bucket(n) for n in (1, 2, 8, 9, 32, 33)] == \
        [1, 8, 8, 32, 32, 64]
    waves = setup['waves']
    paths = [_wav_path(tmp_path, f'c{i}.wav', w) for i, w in enumerate(waves[:2])]
    bad = str(tmp_path / 'bad.wav')
    with open(bad, 'wb') as f:
        f.write(b'not a riff file')
    got = port.predict_speech_paths([paths[0], bad, paths[1]])
    direct = port.predict_speech_waves(np.stack(
        [twav.load_and_fix_length(p)[0] for p in paths]))
    assert got[1]['_fallback'] and got[1]['emotion'] == 'neutral'
    assert got[1]['all_probabilities'][6] == pytest.approx(0.9)
    for g, d in zip((got[0], got[2]), direct):
        assert g['emotion'] == d['emotion'] and '_fallback' not in g
        np.testing.assert_allclose(g['all_probabilities'],
                                   d['all_probabilities'], atol=1e-6)


def test_engine_pcm16_wire_when_compression_off(setup, monkeypatch):
    """The wire follows the compute mode (JAX engine.py:971-998): bf16
    ships 12-bit PCM, or PCM16 with MEC_WIRE_COMPRESS=0; fp32 ships
    float32 either way. (The waveform wire: the host audio features,
    which 'auto' turns on with >= 4 CPUs and g++, are pinned off.)"""
    monkeypatch.setattr(Config, 'HOST_AUDIO_FEATURES', '0')
    port16 = EmotionEngine(setup['tree'], setup['scaler'],
                           compute_dtype='bfloat16', device='cpu')
    waves = setup['waves'][:2]
    wire_arrays = port16._wire_waves(waves, 8)
    assert [a.dtype for a in wire_arrays] == [np.uint8, np.float32]
    ref = port16.predict_speech_waves(waves)
    monkeypatch.setattr(Config, 'WIRE_COMPRESS', False)
    wire_arrays = port16._wire_waves(waves, 8)
    assert len(wire_arrays) == 1 and wire_arrays[0].dtype == np.int16
    got = port16.predict_speech_waves(waves)
    assert [g['emotion'] for g in got] == [r['emotion'] for r in ref]
    fp32 = setup['port']._wire_waves(waves, 8)
    assert len(fp32) == 1 and fp32[0].dtype == np.float32
    np.testing.assert_array_equal(fp32[0][:2], waves)


def test_heuristic_fallback_matches_jax(tmp_path):
    """No speech model: both engines serve the reference's RMS/centroid
    ladder with the 0.9 / 0.1 split."""
    jax_engine = JaxEngine(models_dir=str(tmp_path), mesh=None)
    port = EmotionEngine(device='cpu')
    t = np.arange(N) / 22050.0
    rng = np.random.RandomState(2)
    waves = np.stack([0.005 * np.sin(2 * np.pi * 200 * t),
                      0.5 * rng.randn(N),
                      0.1 * np.sin(2 * np.pi * 1500 * t)]).astype(np.float32)
    got = port.predict_speech_waves(waves)
    ref = jax_engine.predict_speech_waves(waves)
    assert [g['emotion'] for g in got] == [r['emotion'] for r in ref] \
        == ['sad', 'angry', 'neutral']
    for g, r in zip(got, ref):
        assert g['_fallback'] and g['all_probabilities'] == \
            r['all_probabilities']


def test_engine_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the no-card error cannot occur')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        EmotionEngine(device='cuda')
    with pytest.raises(ValueError, match='unsupported device'):
        EmotionEngine(device='meta')


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_unported_modalities_name_their_roadmap_item(dtype):
    """The mixture-of-experts BERT, the last modality that raised here
    (item 12), is served now: an engine given MoE bert_kwargs builds
    the MoE model and predicts (bf16: int8 attention, bf16 experts)."""
    from mec_tpu_torch.serving.synthetic_artifacts import (bert_variables,
                                                           make_vocab)
    vocab = make_vocab()
    widths = dict(vocab_size=max(vocab.values()) + 1, hidden_size=32,
                  num_layers=2, intermediate_size=64, max_position=128)
    eng = EmotionEngine(bert_variables=bert_variables(2, **widths,
                                                      num_experts=4),
                        bert_kwargs=dict(widths, num_heads=2, num_experts=4,
                                         moe_capacity_factor=1.25),
                        bert_vocab=vocab, compute_dtype=dtype, device='cpu')
    assert eng.bert['model'].layer_0.moe.num_experts == 4
    out = eng.predict_texts(['i am so happy today', 'this is sad'])
    assert [len(r['all_probabilities']) for r in out] == [7, 7]
    assert all(abs(sum(r['all_probabilities']) - 1) < 1e-3 for r in out)


# ----------------------------------------------------------------------
# serving: the copied batcher and the unchanged web app
# ----------------------------------------------------------------------

def test_port_batcher_coalesces_speech_requests(setup, tmp_path):
    port = setup['port']
    paths = [_wav_path(tmp_path, f'b{i}.wav', w)
             for i, w in enumerate(setup['waves'][:4])]
    direct = port.predict_speech_paths(paths)
    batcher = EngineBatcher(port, timeout_s=0.05)
    results = [None] * 4
    try:
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, batcher.speech.submit(paths[i])))
            for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        batcher.stop()
    for r, d in zip(results, direct):
        assert r['emotion'] == d['emotion']
        np.testing.assert_allclose(r['all_probabilities'],
                                   d['all_probabilities'], atol=1e-6)
    assert batcher.stats()['speech']['items'] == 4


def test_port_engine_serves_unchanged_webapp(setup, tmp_path):
    """POST /api/predict/speech through mec_tpu.webapp (unchanged) with
    the port's engine: the engine surface drops in."""
    from werkzeug.test import Client
    from mec_tpu.database import Database
    from mec_tpu.webapp.app import create_app
    os.environ['UPLOAD_FOLDER'] = str(tmp_path / 'uploads')
    JaxConfig.UPLOAD_FOLDER = str(tmp_path / 'uploads')
    port = setup['port']
    app = create_app(db=Database(str(tmp_path / 'web.db')), engine=port,
                     testing=True)
    path = _wav_path(tmp_path, 'req.wav', setup['waves'][1])
    with open(path, 'rb') as f:
        body = f.read()
    try:
        r = Client(app).post('/api/predict/speech',
                             data={'audio': (io.BytesIO(body), 'req.wav')})
    finally:
        if app._batcher is not None:
            app._batcher.stop()
    assert r.status_code == 200
    want = port.predict_speech_paths([path])[0]
    assert r.json['emotion'] == want['emotion']
    assert set(r.json) == {'emotion', 'confidence', 'all_probabilities'}
    np.testing.assert_allclose(r.json['all_probabilities'],
                               want['all_probabilities'], atol=1e-6)


# ----------------------------------------------------------------------
# copies pinned to their originals
# ----------------------------------------------------------------------

@pytest.mark.parametrize('name', [
    'EMOTIONS', 'NUM_EMOTIONS', 'SAMPLE_RATE', 'AUDIO_DURATION', 'N_MFCC',
    'AUDIO_SAMPLES', 'N_FFT', 'HOP_LENGTH', 'N_MELS', 'BATCH_BUCKETS',
    'BATCH_TIMEOUT_S', 'BATCH_MAX_LINGER_S', 'BATCH_MAX_PENDING',
    'BATCH_PIPELINE_DEPTH', 'WIRE_COMPRESS', 'IMAGE_SIZE', 'COMPUTE_DTYPE',
    'FOLD_BN', 'IMAGE_INT8', 'INT8_STATIC', 'DFT_PRECISION',
    'MAX_TEXT_LENGTH', 'SEQ_BUCKETS', 'BERT_INT8', 'FUSION_MODE',
    'SPEECH_MODEL_PATH', 'SPEECH_SCALER_PATH', 'TEXT_MODEL_PATH',
    'IMAGE_MODEL_PATH', 'FUSION_MODEL_PATH', 'BERT_MODEL_PATH',
    'FUSION_RF_MODEL_PATH'])
def test_config_copy_matches_original(name):
    assert getattr(Config, name) == getattr(JaxConfig, name)


def _code_without_docstring_and_imports(path):
    with open(path, encoding='utf-8') as f:
        src = f.read()
    body = src.split('"""', 2)[2]                     # drop module docstring
    return re.sub(r'^from mec_tpu(_torch)?\..*$', '', body, flags=re.M)


def test_batcher_copy_matches_original():
    got = _code_without_docstring_and_imports(
        os.path.join(_REPO, 'mec_tpu_torch', 'serving', 'batcher.py'))
    ref = _code_without_docstring_and_imports(
        os.path.join(_REPO, 'mec_tpu', 'serving', 'batcher.py'))
    assert got == ref


def test_stage_timer_copy_matches_original():
    from mec_tpu.utils.profiling import StageTimer as JaxTimer
    from mec_tpu_torch.utils.profiling import StageTimer
    a, b = StageTimer(capacity=8), JaxTimer(capacity=8)
    for ms in (3.0, 1.0, 7.0, 2.0, 9.0, 4.0, 5.0, 8.0, 6.0, 0.5):
        a.record('s', ms)
        b.record('s', ms)
    assert a.summary() == b.summary()
    with a.span('t'):
        pass
    assert a.summary()['t']['count'] == 1
    a.reset()
    assert a.summary() == {}


def test_wire_matches_original_on_engine_input(setup):
    packed, scale = twire.encode_pcm12_np(setup['waves'])
    got = twire.decode_pcm12(torch.from_numpy(packed), torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), _wire_samples(setup['waves']))
