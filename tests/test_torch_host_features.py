"""The port's host audio features (ops/host_features.py,
native/featurizer.py) and the engine under MEC_HOST_AUDIO_FEATURES,
against the JAX package.

The six clips of tests/test_host_features.py (tones, a chord, noise,
silence, a clipped burst) go through both packages. Tolerances, each
with its reason:

* features_56_np and extract56: bit for bit the originals' (the same
  numpy calls on the same tables; the same C++ source and g++ flags);
  extract56 against features_56_np within the original's contract
  (tests/test_host_features.py:83-87: MFCC 1e-2, chroma 1e-3, spectral
  1e-3 relative);
* the engines with the host audio on: the wire is the (bucket, 56)
  float32 features, bit for bit the JAX engine's. The JAX engine's
  speech DNN on a TPU is its Pallas kernel (the port's K4), which here
  runs in interpret mode, as tests/test_pallas.py runs it: on the CPU
  the JAX engine would otherwise take the flax DNN in bf16, which the
  port does not serve. The speech probabilities and penultimate agree
  within 1e-4 (the JAX kernel test's 2e-6 / 2e-5 plus the standardize).
  In the tri-modal step the host flag changes only the speech leg: its
  seven probabilities are held within 1e-4, the text, image and fusion
  legs within the bf16 band of tests/test_torch_trimodal_engine.py
  (0.05, decisions equal where the JAX confidence exceeds 0.6), where
  the bf16 BERT and ResNet already differ by summation order.
"""

import numpy as np
import pytest
import torch

from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert import store as jstore
from mec_tpu.native import featurizer as jfeaturizer
from mec_tpu.ops import host_features as jhf
from mec_tpu.ops import pallas_kernels as pk
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu.serving.synthetic_artifacts import write_synthetic_artifacts
from mec_tpu_torch.config import Config
from mec_tpu_torch.native import featurizer
from mec_tpu_torch.ops import host_features as hf
from mec_tpu_torch.ops import speech_kernels
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import speech_variables
from tests.test_host_features import _clips
from tests.test_torch_trimodal_engine import (TEXTS, _assert_same,
                                              _port_engine, _wave)

N = Config.AUDIO_SAMPLES


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """Six tier-1 workers share the CPU: two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def clips():
    return _clips()


@pytest.fixture(scope='module')
def native(clips):
    if not featurizer.have_native():
        pytest.skip('g++ is not on PATH: the C++ featurizer is not built')
    return featurizer.extract56(clips)


def test_features_56_np_is_the_original(clips):
    np.testing.assert_array_equal(hf.features_56_np(clips),
                                  jhf.features_56_np(clips))
    np.testing.assert_array_equal(hf.features_56_np(clips[1]),
                                  jhf.features_56_np(clips[1]))


def test_extract56_is_the_original(clips, native):
    np.testing.assert_array_equal(native, jfeaturizer.extract56(clips))
    d = np.abs(native - hf.features_56_np(clips))
    assert d[:, :40].max() < 1e-2, 'mfcc'
    assert d[:, 40:52].max() < 1e-3, 'chroma'
    rel = d[:, 52:] / (np.abs(hf.features_56_np(clips)[:, 52:]) + 1.0)
    assert rel.max() < 1e-3, 'spectral'
    for i in range(3):                    # a clip alone is its batch row
        np.testing.assert_array_equal(featurizer.extract56(clips[i])[0],
                                      native[i])


def test_extract56_other_lengths_take_numpy(clips, native):
    short = clips[:2, :N // 2]
    np.testing.assert_array_equal(featurizer.extract56(short),
                                  hf.features_56_np(short))


class _JaxHostAudio:
    """The JAX engine's bf16 speech DNN as on a TPU (its Pallas kernel,
    interpret mode), with MEC_HOST_AUDIO_FEATURES on, for the span of a
    with-block: its graphs trace at the first call, so the JAX engine is
    built and called inside it."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        self.mp.setattr(pk, 'on_tpu', lambda: True)
        self.mp.setattr(pk, '_interpret', lambda: True)
        self.mp.setattr(JaxConfig, 'COMPUTE_DTYPE', 'bfloat16')
        self.mp.setattr(JaxConfig, 'HOST_AUDIO_FEATURES', '1')
        return self

    def __exit__(self, *exc):
        self.mp.undo()


@pytest.fixture(scope='module')
def speech(tmp_path_factory, clips):
    """A bf16 speech engine of each package with the host audio on, over
    one tree and a scaler fitted on the clips' host features; the JAX
    engine's answers taken inside its patch."""
    tree = speech_variables(seed=2)
    waves = np.concatenate([clips, np.stack([_wave(i) for i in range(4)])])
    feats = hf.features_56_np(waves)
    scaler = (feats.mean(axis=0).astype(np.float32),
              (feats.std(axis=0) + 1e-3).astype(np.float32))
    d = tmp_path_factory.mktemp('models')
    jstore.save_params(str(d / 'speech_model.mecp'), tree)
    np.savez(str(d / 'speech_scaler.npz'), mean=scaler[0], scale=scaler[1])
    with _JaxHostAudio():
        jax_eng = JaxEngine(models_dir=str(d), mesh=None)
        assert jax_eng._host_audio
        ref = {B: jax_eng.predict_speech_waves(waves[:B], want_features=True)
               for B in (1, 5, 10)}
        ref_wire = jax_eng._wire_waves(waves[:5], 8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Config, 'HOST_AUDIO_FEATURES', '1')
        port = EmotionEngine(tree, scaler, compute_dtype='bfloat16',
                             device='cpu')
    return {'waves': waves, 'ref': ref, 'ref_wire': ref_wire, 'port': port}


def test_speech_engine_matches_jax_with_host_audio(speech, monkeypatch):
    port, waves = speech['port'], speech['waves']
    assert port._host_audio and port._compress
    (wire,) = port._wire_waves(waves[:5], 8)
    assert wire.shape == (8, 56) and wire.dtype == np.float32
    np.testing.assert_array_equal(wire, speech['ref_wire'])
    # rows already featurized pass through
    np.testing.assert_array_equal(port._wire_waves(wire[:5], 8)[0], wire)
    calls = []
    monkeypatch.setattr(speech_kernels, 'speech_dnn',
                        lambda *a, _f=speech_kernels.speech_dnn:
                        calls.append(1) or _f(*a))
    labels = set()
    for B, ref in speech['ref'].items():
        got = port.predict_speech_waves(waves[:B], want_features=True)
        for g, r in zip(got, ref):
            assert '_fallback' not in g
            np.testing.assert_allclose(g['all_probabilities'],
                                       r['all_probabilities'], atol=1e-4)
            np.testing.assert_allclose(g['_features'], r['_features'],
                                       atol=1e-4)
            top2 = np.sort(r['all_probabilities'])[-2:]
            if top2[1] - top2[0] > 1e-4:
                assert g['emotion'] == r['emotion']
            labels.add(g['emotion'])
    assert len(calls) == 3                 # K4 once a dispatch
    assert len(labels) > 1


def test_speech_engine_host_audio_against_the_waveform_engine(speech,
                                                              monkeypatch):
    """The two audio wires of one bf16 engine agree within the host
    features' error (the waveform engine ships 12-bit PCM through the
    device frontend): decisions equal where the margin is clear."""
    monkeypatch.setattr(Config, 'HOST_AUDIO_FEATURES', '0')
    port = speech['port']
    wave_eng = EmotionEngine(port.speech['variables'],
                             tuple(t.numpy() for t in port.speech['scaler']),
                             compute_dtype='bfloat16', device='cpu')
    assert not wave_eng._host_audio
    waves = speech['waves']
    got = port.predict_speech_waves(waves)
    ref = wave_eng.predict_speech_waves(waves)
    for g, r in zip(got, ref):
        top2 = np.sort(r['all_probabilities'])[-2:]
        if top2[1] - top2[0] > 0.1:
            assert g['emotion'] == r['emotion']


@pytest.fixture(scope='module')
def trimodal(tmp_path_factory):
    """A narrow tri-modal directory (tiny BERT, ResNet50 at 32 px) served
    in bf16 with the host audio on by each package; the JAX engine
    calibrates and caches the int8 scales the port then reads."""
    d = str(tmp_path_factory.mktemp('models'))
    write_synthetic_artifacts(d, tiny=True, image_size=32)
    files = tmp_path_factory.mktemp('uploads')
    from mec_tpu_torch.ops import wav
    from PIL import Image
    rng = np.random.RandomState(3)
    reqs = []
    for i in range(4):
        w, p = str(files / f'a{i}.wav'), str(files / f'i{i}.png')
        wav.write_wav(w, _wave(i), 22050)
        Image.fromarray(rng.randint(0, 256, (48, 48, 3), np.uint8)).save(p)
        reqs.append({'audio_path': w, 'text': TEXTS[i], 'image_path': p})
    with _JaxHostAudio():
        jax_eng = JaxEngine(models_dir=d, mesh=None)
        assert jax_eng._host_audio
        ref_batch = jax_eng.predict_multimodal_batch(reqs)
        ref_single = jax_eng.predict_multimodal(**reqs[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Config, 'HOST_AUDIO_FEATURES', 'on')
        port = _port_engine(d, 'bfloat16')
    return {'port': port, 'reqs': reqs, 'ref_batch': ref_batch,
            'ref_single': ref_single}


def test_trimodal_engine_matches_jax_with_host_audio(trimodal):
    port = trimodal['port']
    assert port._host_audio and port._all_live
    assert port._bert_scales_cached and port._image_scales_cached
    assert port.bert_tokenizer._native is not None     # accelerated
    waves = np.stack([_wave(i) for i in range(3)])
    (wire,) = port._wire_waves(waves, port._bucket(3))
    assert wire.shape == (8, 56) and wire.dtype == np.float32
    got = port.predict_multimodal_batch(trimodal['reqs'])
    single = port.predict_multimodal(**trimodal['reqs'][0])
    for g, r in zip(got + [single],
                    trimodal['ref_batch'] + [trimodal['ref_single']]):
        np.testing.assert_allclose(g['speech']['all_probabilities'],
                                   r['speech']['all_probabilities'],
                                   atol=1e-4)
        assert g['speech']['emotion'] == r['speech']['emotion']
        _assert_same(g, r, 0.05, decisions='confident')


def test_trimodal_warmup_takes_the_features_wire(trimodal, monkeypatch):
    """Warmup's tri-modal dispatches carry the (bucket, 56) wire too and
    launch no frontend wrapper (on the card: K4, K6, K7 and no K1-K3)."""
    from mec_tpu_torch.ops import audio_features as taf
    port = trimodal['port']
    monkeypatch.setattr(Config, 'SEQ_BUCKETS', (16,))
    monkeypatch.setattr(Config, 'MAX_TEXT_LENGTH', 16)
    seen = []
    real = port._trimodal_forward

    def spy(w_wire, *rest):
        seen.append(tuple(w_wire[0].shape))
        return real(w_wire, *rest)

    monkeypatch.setattr(port, '_trimodal_forward', spy)
    monkeypatch.setattr(taf, 'audio_features_56',
                        lambda *a: pytest.fail('device frontend called'))
    port.warmup((1,))
    assert seen == [(1, 56)]
