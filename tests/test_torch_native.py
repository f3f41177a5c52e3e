"""The port's native host runtime (mec_tpu_torch/native) against the JAX
package's (mec_tpu/native) and against its own numpy and Python versions.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:

* the C++ sources, g++ flags and cache key: equal to the original's;
* 12-bit PCM: native, numpy and the JAX package's encoders give the same
  bytes (tests/test_wire.py pins the original's native path to numpy
  bit for bit);
* YUV 4:2:0: the port's native encoder gives the JAX native encoder's
  bytes; against numpy, Y bit for bit and UV within one code, the
  original's contract (tests/test_wire.py:145-146: the C loop's float32
  2x2 chroma mean can round one code away from numpy's);
* WordPiece: ids and mask equal to the Python encoder's and to the JAX
  NativeWordPiece's.

The tests that need g++ skip with that reason where it is absent; the
no-compiler path is driven by hiding g++ from the loader.
"""

import logging
import shutil

import numpy as np
import pytest

from mec_tpu.native import build as jbuild
from mec_tpu.native import tokenizer as jtokenizer
from mec_tpu.serving import wire as jwire
from mec_tpu.serving.synthetic_artifacts import make_vocab
from mec_tpu_torch import native
from mec_tpu_torch.config import Config
from mec_tpu_torch.native import build, featurizer
from mec_tpu_torch.native import tokenizer as ttokenizer
from mec_tpu_torch.ops import host_features
from mec_tpu_torch.serving import wire
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import speech_variables
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer
from tests.test_host_features import _clips

CORPUS = [
    'I am so happy today!',
    'this is terrible... truly AWFUL news',
    'what?! a total surprise',
    'punctuation,everywhere;yes:really(ok)[fine]{sure}',
    'a',
    '',
    'the quick brown fox jumps over the lazy dog ' * 10,  # truncation
    'unknownwordxyzq and the rest',
    '   leading and   trailing   spaces   ',
    'tabs\tand\nnewlines\rhandled',
    'digits 123 mixed42with letters',
]


@pytest.fixture(scope='module')
def built():
    """The three libraries built once for the module (xdist workers that
    build at the same time each rename their own finished file into
    place)."""
    if shutil.which('g++') is None:
        pytest.skip('g++ is not on PATH: the native libraries cannot be '
                    'built here')
    st = native.status()
    assert st == {'wirecodec': True, 'wordpiece': True, 'audiofeat': True}
    return st


@pytest.mark.parametrize('name', build.NAMES)
def test_sources_are_the_originals(name):
    """The C++ files are copies of the JAX package's, byte for byte."""
    with open(f'{build._HERE}/{name}.cpp', 'rb') as f, \
            open(f'{jbuild._HERE}/{name}.cpp', 'rb') as g:
        assert f.read() == g.read()


def test_flags_and_cache_key_are_the_originals(monkeypatch, tmp_path):
    assert list(build.FLAGS) == jbuild._FLAGS
    assert '-ffp-contract=off' in build.FLAGS
    assert '-march=native' in build.FLAGS
    assert build._cpu_fingerprint() == jbuild._cpu_fingerprint()
    monkeypatch.delenv('MEC_NATIVE_BUILD_DIR', raising=False)
    path = build.library_path('wirecodec')
    assert path.parent == build._HERE.parent / '_build' / 'native'
    monkeypatch.setenv('MEC_NATIVE_BUILD_DIR', str(tmp_path))
    assert build.library_path('wirecodec') == tmp_path / path.name
    # another CPU feature set is another file
    monkeypatch.setattr(build, '_cpu_fingerprint', lambda: b'x86_64|sse2')
    assert build.library_path('wirecodec') != tmp_path / path.name


def test_failed_compile_raises_with_gxx_output(monkeypatch, tmp_path):
    """A source g++ rejects raises with g++'s stderr; nothing is cached
    and no partial file is left behind."""
    if shutil.which('g++') is None:
        pytest.skip('g++ is not on PATH')
    src = tmp_path / 'src'
    src.mkdir()
    (src / 'wirecodec.cpp').write_text('int broken( {\n')
    monkeypatch.setattr(build, '_HERE', src)
    monkeypatch.setattr(build, '_cache', {})
    monkeypatch.setenv('MEC_NATIVE_BUILD_DIR', str(tmp_path / 'out'))
    with pytest.raises(RuntimeError, match=r'g\+\+ failed on .*wirecodec'
                       r'.cpp[\s\S]*error'):
        build.load_library('wirecodec')
    assert build._cache == {}
    assert list((tmp_path / 'out').iterdir()) == []


def test_without_gxx_everything_takes_numpy(monkeypatch, tmp_path, caplog):
    """No g++ on PATH: each library is None after one warning, status()
    says so, and the dispatchers run their numpy versions."""
    monkeypatch.setattr(build, '_cache', {})
    monkeypatch.setattr(build, '_warned', False)
    monkeypatch.setattr(build.shutil, 'which', lambda name: None)
    monkeypatch.setenv('MEC_NATIVE_BUILD_DIR', str(tmp_path))
    wire._native.cache_clear()
    featurizer._lib.cache_clear()
    try:
        with caplog.at_level(logging.WARNING, logger='mec_tpu_torch.native'):
            assert native.status() == {'wirecodec': False,
                                       'wordpiece': False,
                                       'audiofeat': False}
            assert build.load_library('wordpiece') is None
        assert len([r for r in caplog.records
                    if 'g++ is not on PATH' in r.getMessage()]) == 1
        clips = _clips()[:2]
        for got, want in zip(wire.encode_pcm12(clips),
                             wire.encode_pcm12_np(clips)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(featurizer.extract56(clips),
                                      host_features.features_56_np(clips))
        tok = WordPieceTokenizer(make_vocab())
        assert not ttokenizer.accelerate(tok)
        with pytest.raises(RuntimeError, match='no g'):
            ttokenizer.NativeWordPiece(tok.vocab, tok.unk_id, tok.cls_id,
                                       tok.sep_id, tok.pad_id)
    finally:
        wire._native.cache_clear()
        featurizer._lib.cache_clear()


def test_odd_shapes_raise_before_the_native_call():
    with pytest.raises(ValueError, match='not even'):
        wire.encode_pcm12(np.zeros((1, 11), np.float32))
    with pytest.raises(ValueError, match='not even'):
        wire.encode_yuv420(np.zeros((1, 4, 5, 3), np.uint8))


# ----------------------------------------------------------------------
# the wire encoders
# ----------------------------------------------------------------------

def test_pcm12_bytes_equal_numpy_and_the_original(built):
    """B=3 full-length clips (a tone, silence, a clipped burst)."""
    waves = _clips()[[0, 3, 5]]
    got = wire.encode_pcm12(waves)
    for want in (wire.encode_pcm12_np(waves), jwire.encode_pcm12(waves),
                 jwire.encode_pcm12_np(waves)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    assert got[0].shape == (3, 66150 * 3 // 2)


def test_yuv420_bytes_equal_the_original(built):
    imgs = np.random.RandomState(0).randint(0, 256, (3, 224, 224, 3),
                                            np.uint8)
    imgs[1] = 255                                   # saturated
    imgs[2, :, :112] = 0
    y8, uv8 = wire.encode_yuv420(imgs)
    jy, juv = jwire.encode_yuv420(imgs)
    np.testing.assert_array_equal(y8, jy)
    np.testing.assert_array_equal(uv8, juv)
    ny, nuv = wire.encode_yuv420_np(imgs)
    np.testing.assert_array_equal(y8, ny)
    assert np.abs(uv8.astype(int) - nuv.astype(int)).max() <= 1
    for g, w in zip((ny, nuv), jwire.encode_yuv420_np(imgs)):
        np.testing.assert_array_equal(g, w)


def test_engine_wires_go_through_the_dispatchers(built, monkeypatch):
    """A bf16 speech engine with the waveform wire encodes through
    encode_pcm12 (the native loop here), never the numpy encoder."""
    monkeypatch.setattr(Config, 'HOST_AUDIO_FEATURES', '0')
    calls = {'native': 0, 'np': 0}
    native_enc, np_enc = wire.encode_pcm12, wire.encode_pcm12_np

    def spy(name, fn):
        def f(*a):
            calls[name] += 1
            return fn(*a)
        return f

    monkeypatch.setattr(wire, 'encode_pcm12', spy('native', native_enc))
    monkeypatch.setattr(wire, 'encode_pcm12_np', spy('np', np_enc))
    eng = EmotionEngine(speech_variables(seed=2), None,
                        compute_dtype='bfloat16', device='cpu')
    packed, scale = eng._wire_waves(_clips()[:2], 8)
    assert calls == {'native': 1, 'np': 0}
    want = native_enc(_clips()[:2])
    np.testing.assert_array_equal(packed[:2], want[0])
    np.testing.assert_array_equal(scale[:2], want[1])
    assert packed.shape == (8, 66150 * 3 // 2) and not packed[2:].any()


# ----------------------------------------------------------------------
# the WordPiece encoder
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def vocab():
    return make_vocab()


def _natives(vocab):
    tok = WordPieceTokenizer(vocab)
    args = (vocab, tok.unk_id, tok.cls_id, tok.sep_id, tok.pad_id)
    return tok, ttokenizer.NativeWordPiece(*args), \
        jtokenizer.NativeWordPiece(*args)


@pytest.mark.parametrize('max_len,texts', [
    (16, CORPUS), (32, CORPUS), (128, CORPUS),
    (24, CORPUS * 5)])                        # 55 texts: the threaded path
def test_wordpiece_equals_python_and_the_original(built, vocab, max_len,
                                                  texts):
    py, port, jax_native = _natives(vocab)
    ids, mask = port.encode_batch(texts, max_len)
    assert ids.shape == mask.shape == (len(texts), max_len)
    for want in (py.encode_batch(texts, max_len),
                 jax_native.encode_batch(texts, max_len)):
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(mask, want[1])


def test_accelerate_routes_non_ascii_and_nul_to_python(built, vocab,
                                                       monkeypatch):
    tok = WordPieceTokenizer(vocab)
    ref = WordPieceTokenizer(vocab)
    assert ttokenizer.accelerate(tok)
    calls = []
    enc = tok._native.encode_batch
    monkeypatch.setattr(tok._native, 'encode_batch',
                        lambda t, n: calls.append(len(t)) or enc(t, n))
    for texts, native_path in ((CORPUS, True),
                               (['héllo wörld ünïcode', 'happy'], False),
                               (['happy\x00sad day', 'calm'], False)):
        ids, mask = tok.encode_batch(texts, 32)
        want = ref.encode_batch(texts, 32)
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(mask, want[1])
        assert bool(calls) == native_path
        calls.clear()
    assert not ttokenizer.accelerate(WordPieceTokenizer(vocab,
                                                        do_lower_case=False))
