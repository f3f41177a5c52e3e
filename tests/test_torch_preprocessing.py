"""The port's preprocessing facade (mec_tpu_torch/preprocessing) against
the JAX package's (mec_tpu/preprocessing).

The same WAV files (seeded with numpy), texts and images go through
both. Tolerances, each with its reason:

* the audio functions: both run the reference's fp32 parity graph (the
  JAX package's XLA path on the CPU, the port's
  audio_features_56(y, 'parity') on device='cpu'); within 1e-4 plus
  2e-6 relative, the parity contract of tests/test_torch_parity.py
  (MFCC0 of a quiet clip is near -600, where one float32 step is 6e-5);
* text and image: equal (the same code on the same bytes).
"""

import numpy as np
import pytest
import torch

from mec_tpu.preprocessing import audio_preprocessing as jap
from mec_tpu.preprocessing import image_preprocessing as jip
from mec_tpu.preprocessing import text_preprocessing as jtp
from mec_tpu.serving.synthetic_artifacts import make_vocab
from mec_tpu_torch.ops import wav
from mec_tpu_torch.preprocessing import audio_preprocessing as ap
from mec_tpu_torch.preprocessing import image_preprocessing as ip
from mec_tpu_torch.preprocessing import text_preprocessing as tp
from tests.test_host_features import _clips

ATOL, RTOL = 1e-4, 2e-6


@pytest.fixture(scope='module')
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp('wavs')
    paths = []
    clips = _clips()
    for i in (0, 1, 2, 4):
        paths.append(str(d / f'c{i}.wav'))
        wav.write_wav(paths[-1], clips[i], 22050)
    short = str(d / 'short.wav')                    # padded to 3 s
    wav.write_wav(short, clips[1][:30000], 22050)
    return paths + [short]


def test_preprocess_audio_matches_jax(wavs):
    for p in wavs:
        got = ap.preprocess_audio(p, device='cpu')
        assert got.shape == (56,) and got.dtype == np.float32
        np.testing.assert_allclose(got, jap.preprocess_audio(p),
                                   atol=ATOL, rtol=RTOL)


def test_preprocess_audio_batch_matches_jax(wavs):
    got = ap.preprocess_audio_batch(wavs, device='cpu')
    assert got.shape == (len(wavs), 56) and got.dtype == np.float32
    np.testing.assert_allclose(got, jap.preprocess_audio_batch(wavs),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('fn,size', [('extract_mfcc', 40),
                                     ('extract_chroma', 12),
                                     ('extract_spectral_features', 4)])
def test_feature_functions_match_jax(fn, size):
    clips = _clips()
    for y in (clips[0], clips[2], clips[1][:30000]):
        got = getattr(ap, fn)(y, device='cpu')
        assert got.shape == (size,) and got.dtype == np.float32
        np.testing.assert_allclose(got, getattr(jap, fn)(y), atol=ATOL,
                                   rtol=RTOL)
    assert ap.extract_mfcc(clips[0], n_mfcc=13, device='cpu').shape == (13,)


def test_load_audio_matches_jax(wavs):
    y, sr = ap.load_audio(wavs[-1])
    jy, jsr = jap.load_audio(wavs[-1])
    assert sr == jsr == 22050 and y.shape == (66150,)
    np.testing.assert_array_equal(y, jy)


def test_cuda_default_needs_a_card(wavs):
    """'cuda' is the default and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default runs there')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ap.preprocess_audio(wavs[0])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ap.extract_mfcc(_clips()[0])
    with pytest.raises(ValueError, match='unsupported device'):
        ap.extract_chroma(_clips()[0], device='meta')


@pytest.fixture(scope='module')
def bert_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('bert_model')
    vocab = make_vocab()
    with open(d / 'vocab.txt', 'w', encoding='utf-8') as f:
        for tok, _ in sorted(vocab.items(), key=lambda kv: kv[1]):
            f.write(tok + '\n')
    return str(d)


@pytest.mark.parametrize('text', [
    'I am SO happy today!!! <b>really</b> http://example.com',
    'this is terrible and sad',
    '',
    'héllo wörld, ünïcode'])
def test_text_preprocessor_matches_jax(bert_dir, text):
    got = tp.TextPreprocessor(model_dir=bert_dir, max_length=32)
    ref = jtp.TextPreprocessor(model_dir=bert_dir, max_length=32)
    assert got.clean_text(text) == ref.clean_text(text)
    g, r = got.preprocess_text(text), ref.preprocess_text(text)
    assert set(g) == set(r) == {'input_ids', 'attention_mask'}
    for k in g:
        assert g[k].shape == (1, 32)
        np.testing.assert_array_equal(g[k], r[k])


def test_text_preprocessor_without_a_model(tmp_path):
    got = tp.TextPreprocessor(model_dir=str(tmp_path / 'missing'))
    assert got.tokenizer is None and got.tokenize_bert('happy') is None
    assert tp.TextPreprocessor(model_type='lstm').tokenizer is None


def test_image_preprocessing_matches_jax(tmp_path):
    cv2 = pytest.importorskip('cv2')
    p = str(tmp_path / 'img.png')
    cv2.imwrite(p, np.random.RandomState(0).randint(
        0, 255, (120, 160, 3), np.uint8))
    np.testing.assert_array_equal(ip.detect_face(p), jip.detect_face(p))
    out = ip.preprocess_image(p)
    assert out.shape == (1, 224, 224, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jip.preprocess_image(p))
    assert ip.detect_face(str(tmp_path / 'missing.png')) is None
    with pytest.raises(ValueError, match='Unable to read'):
        ip.preprocess_image(str(tmp_path / 'missing.png'))
