"""The port's tri-modal serving path (mec_tpu_torch) against the JAX engine.

write_synthetic_artifacts(tiny=True, image_size=32) writes the JAX
package's five artifacts (speech DNN, tiny BERT with its vocab and
config, the Bi-LSTM the port does not serve, ResNet50 at 32 px, the
fusion net). The JAX EmotionEngine loads them from that directory; the
port's engine is given the same numpy trees, read back from the .mecp
files. In bf16 the JAX engine calibrates its int8 static scales at load
and caches them in the .mecp meta, and the port reads them from there
by the JAX engine's keys, so both quantize with the same scales.
Tolerances, each with its reason:

* fp32 parity mode: every probability, attention and decision weight
  within 1e-4 (the port's parity contract), decisions equal;
* bf16 serving mode: probabilities within 0.05, the band
  tests/test_inference.py holds the bf16 tri-modal engine to against
  fp32 (the JAX CPU engine runs the flax SpeechDNN in bf16 where the
  port runs the fp32 K4 kernel, and the bf16 matmuls accumulate in
  other orders), decisions equal wherever the JAX confidence exceeds
  0.6 (tests/test_quant.py's rule);
* the degraded ladder and the fallbacks: equal dicts (fallbacks are
  exact 0.9/0.1 splits; the live modalities within 1e-4).

Also here: the web app's text and multimodal routes through
create_app(engine=port), warmup over the sequence buckets, the
batcher's text and multimodal lanes, and the batch-1 phase clock
(_last_b1_phases: the JAX engine's keys, phases summing to the call's
wall within max(1 ms, 15%), empty after a degraded request).
"""

import io
import json
import os
import threading
import time

import numpy as np
import pytest
from PIL import Image

from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert import store
from mec_tpu.convert.hf_bert import model_kwargs_from_config
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu.serving.synthetic_artifacts import write_synthetic_artifacts
from mec_tpu_torch.ops import quant
from mec_tpu_torch.serving.batcher import EngineBatcher
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer

N = 66150
TEXTS = ['i am so happy today', 'this is terrible and sad',
         'wow what a surprise', 'i feel angry about all of this']


def _jax_engine(models_dir, dtype):
    old = JaxConfig.COMPUTE_DTYPE
    JaxConfig.COMPUTE_DTYPE = dtype
    try:
        return JaxEngine(models_dir=models_dir, mesh=None)
    finally:
        JaxConfig.COMPUTE_DTYPE = old


def _port_engine(d, dtype):
    """The port's engine over the trees of the artifacts in d."""
    load = lambda name: store.load_params(os.path.join(d, name))  # noqa
    bert_dir = os.path.join(d, 'bert_model')
    with open(os.path.join(bert_dir, 'config.json')) as f:
        bert_kwargs = model_kwargs_from_config(json.load(f))
    bert, image, fusion = (load('bert_model/bert_model.mecp'),
                           load('image_model.mecp'), load('fusion_model.mecp'))
    scaler = np.load(os.path.join(d, 'speech_scaler.npz'))
    return EmotionEngine(
        load('speech_model.mecp')['variables'],
        (scaler['mean'], scaler['scale']),
        image_variables=image['variables'], image_meta=image['meta'],
        bert_variables=bert['variables'], bert_kwargs=bert_kwargs,
        bert_vocab=WordPieceTokenizer.from_pretrained_dir(bert_dir),
        bert_meta=bert['meta'], fusion_variables=fusion['variables'],
        fusion_config=fusion['meta']['config'], compute_dtype=dtype,
        device='cpu')


def _wave(i):
    rng = np.random.RandomState(i)
    t = np.arange(N) / 22050.0
    y = (0.05 + 0.1 * i) * np.sin(2 * np.pi * (200 + 150 * i) * t)
    return (y + 0.01 * rng.randn(N)).astype(np.float32)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('models'))
    write_synthetic_artifacts(d, tiny=True, image_size=32)
    jax32 = _jax_engine(d, 'float32')
    jax16 = _jax_engine(d, 'bfloat16')      # caches its int8 scales in d
    assert jax16._bert_quant_mode == jax16._image_quant_mode == 'static'
    runs = quant.CALIBRATION_RUNS
    port16 = _port_engine(d, 'bfloat16')
    assert quant.CALIBRATION_RUNS == runs    # the JAX engine's scales
    assert port16._bert_scales_cached and port16._image_scales_cached
    files = tmp_path_factory.mktemp('uploads')
    wavs, pngs = [], []
    rng = np.random.RandomState(3)
    from mec_tpu_torch.ops import wav
    for i in range(4):
        wavs.append(str(files / f'a{i}.wav'))
        wav.write_wav(wavs[-1], _wave(i), 22050)
        pngs.append(str(files / f'i{i}.png'))
        Image.fromarray(rng.randint(0, 256, (40 + 8 * i, 48, 3), np.uint8)
                        ).save(pngs[-1])
    bad_wav, bad_png = str(files / 'bad.wav'), str(files / 'bad.png')
    for p in (bad_wav, bad_png):
        with open(p, 'wb') as f:
            f.write(b'not a media file')
    return {'dir': d, 'jax32': jax32, 'jax16': jax16,
            'port32': _port_engine(d, 'float32'), 'port16': port16,
            'wavs': wavs, 'pngs': pngs, 'bad_wav': bad_wav,
            'bad_png': bad_png}


def _requests(s, n=4):
    return [{'audio_path': s['wavs'][i], 'text': TEXTS[i],
             'image_path': s['pngs'][i]} for i in range(n)]


def _assert_same(got, ref, atol, decisions='all'):
    """Same keys and flags; probabilities (and fusion weights) within
    atol; decisions equal (all, or where ref is confident)."""
    assert set(got) == set(ref)
    for mod in ref:
        g, r = got[mod], ref[mod]
        assert set(g) == set(r), mod
        assert g.get('_fallback') == r.get('_fallback')
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=atol,
                                   err_msg=mod)
        for k in ('attention_weights', 'decision_weights'):
            if k in r:
                np.testing.assert_allclose(
                    [g[k][m] for m in ('speech', 'text', 'image')],
                    [r[k][m] for m in ('speech', 'text', 'image')],
                    atol=atol, err_msg=f'{mod} {k}')
        if decisions == 'all' or r['confidence'] > 0.6:
            assert g['emotion'] == r['emotion'], mod


# ----------------------------------------------------------------------
# the slice as a whole
# ----------------------------------------------------------------------

def test_fp32_predict_multimodal_matches_jax(setup):
    for req in _requests(setup, 2):
        ref = setup['jax32'].predict_multimodal(**req)
        got = setup['port32'].predict_multimodal(**req)
        assert set(got) == {'speech', 'text', 'image', 'fusion'}
        assert 'attention_weights' in got['fusion']
        _assert_same(got, ref, 1e-4)


def test_fp32_predict_multimodal_batch_matches_jax(setup):
    reqs = _requests(setup, 3) + [{'text': 'i feel sad'}]
    ref = setup['jax32'].predict_multimodal_batch(reqs)
    got = setup['port32'].predict_multimodal_batch(reqs)
    assert len(got) == 4 and set(got[3]) == {'text'}
    for g, r in zip(got, ref):
        _assert_same(g, r, 1e-4)
    # one packed row per request: batched == one at a time
    single = setup['port32'].predict_multimodal(**reqs[1])
    _assert_same(got[1], single, 1e-5)


def test_bf16_trimodal_matches_jax(setup):
    port = setup['port16']
    assert port._bert_quant and port._bert_quant_mode == 'static'
    reqs = _requests(setup, 4)
    ref = setup['jax16'].predict_multimodal_batch(reqs)
    got = port.predict_multimodal_batch(reqs)
    for g, r in zip(got, ref):
        _assert_same(g, r, 0.05, decisions='confident')
    single = port.predict_multimodal(**reqs[0])
    _assert_same(single, setup['jax16'].predict_multimodal(**reqs[0]),
                 0.05, decisions='confident')


def test_texts_and_fuse_attention_match_jax(setup):
    ref = setup['jax32'].predict_texts(TEXTS, want_features=True)
    got = setup['port32'].predict_texts(TEXTS, want_features=True)
    for g, r in zip(got, ref):
        assert g['emotion'] == r['emotion']
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=1e-4)
        np.testing.assert_allclose(g['_features'], r['_features'], atol=1e-4)
        assert g['_features'].shape == (64,)
    rng = np.random.RandomState(1)
    args = (rng.randn(64), rng.randn(64), rng.randn(512),
            *(rng.dirichlet(np.ones(7)) for _ in range(3)))
    ref = setup['jax32'].fuse_attention(*args)
    got = setup['port32'].fuse_attention(*args)
    _assert_same({'fusion': got}, {'fusion': ref}, 1e-4)
    assert setup['port32'].fuse_weighted(*args[3:]) == \
        setup['jax32'].fuse_weighted(*args[3:])


def test_degraded_ladder_matches_jax(setup):
    """A bad WAV or a bad image: per-modality results, the fallback for
    the bad upload and the weighted fusion, alone and inside a batch,
    as the JAX engine gives them."""
    s = setup
    bad = [{'audio_path': s['bad_wav'], 'text': TEXTS[0],
            'image_path': s['pngs'][0]},
           {'audio_path': s['wavs'][1], 'text': TEXTS[1],
            'image_path': s['bad_png']}]
    for req in bad:
        ref = s['jax32'].predict_multimodal(**req)
        got = s['port32'].predict_multimodal(**req)
        assert 'attention_weights' not in got['fusion']
        _assert_same(got, ref, 1e-4)
    ref = s['jax32'].predict_multimodal_batch(bad + _requests(s, 1))
    got = s['port32'].predict_multimodal_batch(bad + _requests(s, 1))
    assert got[0]['speech']['_fallback'] and got[1]['image']['_fallback']
    assert 'attention_weights' in got[2]['fusion']
    for g, r in zip(got, ref):
        _assert_same(g, r, 1e-4)
    pre = s['port32'].predecode_multimodal(bad[1])
    assert pre.get('wave') is not None and pre.get('image') is None
    _assert_same(s['port32'].predict_multimodal_batch([pre])[0], ref[1],
                 1e-4)


@pytest.mark.parametrize('mode', ['32', '16'])
def test_b1_phase_clock_has_the_jax_keys(setup, mode):
    """_last_b1_phases starts empty and, after one fused request, holds
    the JAX engine's (non-streaming) phase keys for the same request."""
    port, ref = setup['port' + mode], setup['jax' + mode]
    assert EmotionEngine(device='cpu')._last_b1_phases == {}
    req = _requests(setup, 1)[0]
    ref.predict_multimodal(**req)
    port.predict_multimodal(**req)
    assert set(port._last_b1_phases) == set(ref._last_b1_phases) == {
        'wav_load', 'tokenize', 'image_load', 'wire_encode',
        'dispatch_fetch', 'result_unpack'}
    assert all(v >= 0 for v in port._last_b1_phases.values())


@pytest.mark.parametrize('mode', ['32', '16'])
def test_b1_phases_sum_to_the_wall(setup, mode):
    """The phases are timed in the call itself, so they add up to its
    wall within max(1 ms, 15%) (tests/test_bench_contract.py's bound for
    bench.py's decomposition of the JAX engine's)."""
    port = setup['port' + mode]
    for req in _requests(setup, 2):
        t0 = time.perf_counter()
        port.predict_multimodal(**req)
        wall = (time.perf_counter() - t0) * 1e3
        total = sum(port._last_b1_phases.values())
        assert abs(total - wall) <= max(1.0, 0.15 * wall), \
            (total, wall, port._last_b1_phases)


def test_degraded_request_leaves_no_b1_phases(setup):
    """A request that takes the fallback ladder clears the previous
    request's phases instead of leaving them in place."""
    s = setup
    port = s['port32']
    bad = [{'audio_path': s['bad_wav'], 'text': TEXTS[0],
            'image_path': s['pngs'][0]},
           {'audio_path': s['wavs'][1], 'text': TEXTS[1],
            'image_path': s['bad_png']}]
    for req in bad:
        port.predict_multimodal(**_requests(s, 1)[0])
        assert port._last_b1_phases
        port.predict_multimodal(**req)
        assert port._last_b1_phases == {}


def test_missing_bert_serves_the_keyword_heuristic(setup):
    port = EmotionEngine(device='cpu')
    jax = JaxEngine(models_dir=os.path.join(setup['dir'], 'nothing'),
                    mesh=None)
    texts = ['I am so happy!', 'this is disgusting and gross', 'hmm',
             'I was terrified', 'WOW']
    assert port.predict_texts(texts) == jax.predict_texts(texts)
    assert [r['emotion'] for r in port.predict_texts(texts)] == \
        ['happy', 'disgust', 'neutral', 'fear', 'surprise']
    # a BERT tree without a vocab disables the text model, as in JAX
    no_vocab = EmotionEngine(bert_variables={'params': {}}, device='cpu')
    assert no_vocab.bert is None
    assert no_vocab.predict_texts(['so sad']) == jax.predict_texts(['so sad'])
    # no fusion net: the weighted average of the per-modality results
    req = {'audio_path': setup['wavs'][0], 'text': 'so sad',
           'image_path': setup['pngs'][0]}
    _assert_same(port.predict_multimodal(**req),
                 jax.predict_multimodal(**req), 1e-4)


def test_warmup_covers_every_sequence_bucket(setup, monkeypatch):
    port = setup['port32']
    seen = []
    real = port._trimodal_forward

    def spy(w_wire, ids, mask, i_wire):
        seen.append(tuple(ids.shape))
        return real(w_wire, ids, mask, i_wire)

    monkeypatch.setattr(port, '_trimodal_forward', spy)
    port.warmup((1,))
    assert seen == [(1, 16), (1, 32), (1, 128)]


def test_batcher_text_and_multimodal_lanes(setup):
    port = setup['port32']
    reqs = _requests(setup, 3)
    direct_t = port.predict_texts(TEXTS[:3])
    direct_m = port.predict_multimodal_batch(reqs)
    batcher = EngineBatcher(port, timeout_s=0.05)
    out_t, out_m = [None] * 3, [None] * 3
    try:
        threads = [threading.Thread(target=lambda i=i: (
            out_t.__setitem__(i, batcher.text.submit(TEXTS[i])),
            out_m.__setitem__(i, batcher.multimodal.submit(reqs[i]))))
            for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        batcher.stop()
    for g, r in zip(out_t, direct_t):
        _assert_same({'t': g}, {'t': r}, 1e-5)
    for g, r in zip(out_m, direct_m):
        _assert_same(g, r, 1e-5)


def test_port_engine_serves_text_and_multimodal_routes(setup, tmp_path):
    from werkzeug.test import Client
    from mec_tpu.database import Database
    from mec_tpu.webapp.app import create_app
    os.environ['UPLOAD_FOLDER'] = str(tmp_path / 'uploads')
    JaxConfig.UPLOAD_FOLDER = str(tmp_path / 'uploads')
    port = setup['port32']
    app = create_app(db=Database(str(tmp_path / 'web.db')), engine=port,
                     testing=True)
    client = Client(app)
    with open(setup['wavs'][0], 'rb') as f:
        audio = f.read()
    with open(setup['pngs'][0], 'rb') as f:
        png = f.read()
    try:
        rt = client.post('/api/predict/text', json={'text': TEXTS[0]})
        rm = client.post('/api/predict/multimodal', data={
            'text': TEXTS[0], 'audio': (io.BytesIO(audio), 'a.wav'),
            'image': (io.BytesIO(png), 'i.png')})
    finally:
        if app._batcher is not None:
            app._batcher.stop()
    assert rt.status_code == 200 and rm.status_code == 200
    want_t = port.predict_texts([TEXTS[0]])[0]
    assert rt.json == pytest.approx(want_t)
    want = port.predict_multimodal(setup['wavs'][0], TEXTS[0],
                                   setup['pngs'][0])
    assert set(rm.json) == {'speech', 'text', 'image', 'fusion'}
    assert set(rm.json['fusion']) == {'emotion', 'confidence',
                                      'all_probabilities',
                                      'attention_weights',
                                      'decision_weights'}
    _assert_same(rm.json, want, 1e-6)
