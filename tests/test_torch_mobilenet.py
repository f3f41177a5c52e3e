"""The port's MobileNetV2 (mec_tpu_torch/models/mobilenet.py) against the
JAX package's (mec_tpu/models/mobilenet.py), alone and served from a
models directory.

The model: numpy-seeded trees (serving/synthetic_artifacts.
mobilenet_variables) through both packages on the CPU at 32 and 48 px.
Tolerances, each with its reason:

* fp32 live BN, and fp32 with BN folded: logits and the 512-dim head
  feature within 1e-4 (the port's parity contract);
* fold and quantize: identical trees (numpy copies; the 1x1 expand and
  project convs and conv_head quantized, conv_stem, the depthwise 3x3s
  and fc1/fc2 not);
* bf16 folded int8 static, given the same scales (the JAX package's
  calibration): probabilities within 0.05 and decisions equal wherever
  the JAX confidence exceeds 0.6, tests/test_quant.py's band and rule
  for MobileNetV2 (bf16 convs accumulate in other orders in oneDNN and
  XLA:CPU).

The engine: the JAX writer's directory (tiny, MobileNetV2 at 32 px, no
Bi-LSTM) plus an 8-tree depth-6 forest fitted by sklearn on the JAX
trainer's synthetic softmax data (tests/test_torch_models_dir.py::
write_forest). A port engine built first in bf16
calibrates and writes its scales into the .mecp metas under the JAX
engine's keys (image|mobilenet_v2|...: fault F2); the JAX engine built
next, and a second port engine, take them from there. Tolerances:
per-modality probabilities 1e-4 in fp32 and 0.05 in bf16 (decisions
equal where the JAX confidence exceeds 0.6, as in
tests/test_torch_trimodal_engine.py); the rf tail held as in
tests/test_torch_models_dir.py (rf_tail_agreement).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mec_tpu.convert import store as jstore
from mec_tpu.models.mobilenet import MobileNetV2EmotionModel as JaxModel
from mec_tpu.ops import fold as jfold
from mec_tpu.ops import quant as jquant
from mec_tpu.serving.synthetic_artifacts import write_synthetic_artifacts
from mec_tpu_torch.convert.from_jax import mobilenet_state_from_jax
from mec_tpu_torch.models.mobilenet import MobileNetV2EmotionModel
from mec_tpu_torch.ops import fold, quant, wav
from mec_tpu_torch.serving.synthetic_artifacts import mobilenet_variables
from tests.test_torch_image import _trees_equal
from tests.test_torch_models_dir import (jax_engine, port_engine,
                                         rf_tail_agreement, write_forest)

N = 66150
TEXTS = ['i am so happy today', 'this is terrible and sad',
         'wow what a surprise', 'i feel angry about all of this']


def _imgs(n, size, seed=0):
    rng = np.random.RandomState(seed)
    grad = np.broadcast_to(np.linspace(0, 255, size)[None, :, None],
                           (size, size, 3))
    frames = [rng.randint(0, 256, (size, size, 3)), grad,
              np.full((size, size, 3), [255, 0, 0])]
    frames += [rng.randint(40 * i % 128, 256, (size, size, 3))
               for i in range(n - 3)]
    return np.stack(frames[:n]).astype(np.uint8)


def _normalized(imgs):
    x = imgs.astype(np.float32) / 255.0
    return ((x - np.array([0.485, 0.456, 0.406], np.float32))
            / np.array([0.229, 0.224, 0.225], np.float32)).astype(np.float32)


def _port(tree, **kw):
    model = MobileNetV2EmotionModel(**kw)
    model.load_state_dict(mobilenet_state_from_jax(tree))
    return model.eval()


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize('size', [32, 48])
def test_fp32_model_matches_jax(size):
    tree, meta = mobilenet_variables(seed=size, image_size=size)
    assert meta == {'arch': 'mobilenet_v2', 'img_size': size}
    x = _normalized(_imgs(4, size, seed=size))
    jl, jf = JaxModel().apply(tree, jnp.asarray(x))
    with torch.inference_mode():
        logits, feat = _port(tree)(torch.from_numpy(x))
    assert logits.shape == (4, 7) and feat.shape == (4, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jf), atol=1e-4)
    if size == 48:     # the folded form, in fp32: the same function
        folded = fold.fold_conv_bn(tree)
        with torch.inference_mode():
            fl, ff = _port(folded, fold_bn=True)(torch.from_numpy(x))
        np.testing.assert_allclose(fl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(ff.numpy(), np.asarray(jf), atol=1e-4)


def test_int8_static_model_matches_jax_given_its_scales():
    tree, _ = mobilenet_variables(seed=3, image_size=32)
    folded = fold.fold_conv_bn(tree)
    q = quant.quantize_image_params(folded)
    _trees_equal(folded, jfold.fold_conv_bn(tree))
    _trees_equal(q, jquant.quantize_image_params(folded))
    p = q['params']
    assert 'kernel_q' in p['conv_head'] and 'kernel' in p['conv_stem']
    assert 'kernel' in p['fc1'] and 'kernel_q' not in p['block_1']['dw_conv']
    assert 'kernel_q' in p['block_2']['expand_conv']
    assert 'kernel_q' in p['block_2']['project_conv']

    x = _normalized(_imgs(6, 32, seed=1))
    jcal = jquant.calibrate_static_scales(
        JaxModel(dtype=jnp.bfloat16, fold_bn=True, quant=True), q,
        (jnp.asarray(x[:2]),))
    scales = jquant.extract_static_scales(jcal)
    assert len(scales) == 34      # 16 expand + 17 project + conv_head
    cal = quant.insert_static_scales(q, scales)
    static = _port(cal, dtype=torch.bfloat16, fold_bn=True, quant=True,
                   quant_mode='static')
    with torch.inference_mode():
        logits, _ = static(torch.from_numpy(x))
    jl, _ = JaxModel(dtype=jnp.bfloat16, fold_bn=True, quant=True,
                     quant_mode='static').apply(
        jax.tree_util.tree_map(jnp.asarray, jcal), jnp.asarray(x))
    pg = torch.softmax(logits, -1).numpy()
    pw = np.asarray(jax.nn.softmax(jl))
    np.testing.assert_allclose(pg, pw, atol=0.05)
    confident = pw.max(-1) > 0.6
    assert (pw.argmax(-1) == pg.argmax(-1))[confident].all()
    # the port's own calibration gives scales close to the JAX package's
    dyn = _port(q, dtype=torch.bfloat16, fold_bn=True, quant=True)
    own = quant.extract_static_scales(quant.calibrate_static_scales(
        dyn, q, torch.from_numpy(x[:2])))
    assert set(own) == set(scales)
    for k in scales:
        assert abs(own[k] - scales[k]) <= 5e-2 * scales[k], k


# ----------------------------------------------------------------------
# a MobileNetV2 models directory, against the JAX engine
# ----------------------------------------------------------------------

def _requests(files, n=4):
    return [{'audio_path': files['wavs'][i], 'text': TEXTS[i],
             'image_path': files['pngs'][i]} for i in range(n)]


@pytest.fixture(scope='module')
def mobile(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('mobilenet_models'))
    write_synthetic_artifacts(d, tiny=True, image_arch='mobilenet_v2',
                              image_size=32, seed=1)
    for f in ('text_model.mecp', 'text_model_tokenizer.json'):
        os.remove(os.path.join(d, f))          # no Bi-LSTM here
    rf = write_forest(d)
    runs = quant.CALIBRATION_RUNS
    port16 = port_engine(d, 'bfloat16', 'rf')  # calibrates, writes back
    assert quant.CALIBRATION_RUNS == runs + 2
    assert not (port16._image_scales_cached or port16._bert_scales_cached)
    jax16 = jax_engine(d, 'bfloat16', 'rf')
    again = port_engine(d, 'bfloat16', 'rf')
    assert quant.CALIBRATION_RUNS == runs + 2
    files = tmp_path_factory.mktemp('mobilenet_uploads')
    wavs, pngs = [], []
    rng = np.random.RandomState(5)
    t = np.arange(N) / 22050.0
    for i in range(4):
        wavs.append(str(files / f'a{i}.wav'))
        y = (0.1 + 0.1 * i) * np.sin(2 * np.pi * (180 + 170 * i) * t)
        wav.write_wav(wavs[-1], (y + 0.01 * rng.randn(N)).astype(np.float32),
                      22050)
        pngs.append(str(files / f'i{i}.png'))
        Image.fromarray(_imgs(4, 32, seed=i)[i]).save(pngs[-1])
    return {'dir': d, 'rf': rf, 'port16': port16, 'jax16': jax16,
            'again': again, 'jax32': jax_engine(d, 'float32', 'attention'),
            'port32': port_engine(d, 'float32', 'attention'),
            'files': {'wavs': wavs, 'pngs': pngs}}


def test_scales_written_back_are_taken_up_by_jax(mobile):
    """F2: the image key names the architecture, so the JAX engine finds
    the port's MobileNetV2 scales (and BERT's) in the .mecp metas."""
    meta = jstore.load_params(os.path.join(mobile['dir'],
                                           'image_model.mecp'))['meta']
    assert list(meta['int8_scales']) == [
        'image|mobilenet_v2|32x32|bfloat16|m1.25|v1']
    assert meta['arch'] == 'mobilenet_v2' and meta['img_size'] == 32
    for eng in (mobile['jax16'], mobile['again']):
        assert eng._image_scales_cached and eng._bert_scales_cached
        assert eng._image_quant_mode == eng._bert_quant_mode == 'static'
    assert mobile['port16']._image_arch == 'mobilenet_v2'
    jax_scales = jquant.extract_static_scales(
        jax.tree_util.tree_map(np.asarray, mobile['jax16'].image['variables']))
    assert jax_scales == quant.extract_static_scales(
        mobile['port16'].image['variables'])


def test_fp32_engine_matches_jax(mobile):
    imgs = _imgs(5, 32, seed=9)
    got = mobile['port32'].predict_images(imgs, want_features=True)
    ref = mobile['jax32'].predict_images(imgs, want_features=True)
    for g, r in zip(got, ref):
        assert g['emotion'] == r['emotion'] and '_fallback' not in g
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=1e-4)
        np.testing.assert_allclose(g['_features'], r['_features'], atol=1e-4)
    reqs = _requests(mobile['files'])
    for g, r in zip(mobile['port32'].predict_multimodal_batch(reqs),
                    mobile['jax32'].predict_multimodal_batch(reqs)):
        assert 'attention_weights' in g['fusion']
        for mod in ('speech', 'text', 'image', 'fusion'):
            assert g[mod]['emotion'] == r[mod]['emotion'], mod
            np.testing.assert_allclose(g[mod]['all_probabilities'],
                                       r[mod]['all_probabilities'],
                                       atol=1e-4, err_msg=mod)


def test_bf16_rf_engine_matches_jax(mobile):
    reqs = _requests(mobile['files'])
    got = mobile['port16'].predict_multimodal_batch(reqs)
    ref = mobile['jax16'].predict_multimodal_batch(reqs)
    for g, r in zip(got, ref):
        assert g['fusion']['method'] == 'random_forest'
        assert 'attention_weights' not in g['fusion']
        for mod in ('speech', 'text', 'image'):
            np.testing.assert_allclose(g[mod]['all_probabilities'],
                                       r[mod]['all_probabilities'],
                                       atol=0.05, err_msg=mod)
            if r[mod]['confidence'] > 0.6:
                assert g[mod]['emotion'] == r[mod]['emotion'], mod
    _rows, _near, trees, _trees_near = rf_tail_agreement(
        mobile['port16'], got, ref, tol=0.05)
    assert trees > 0
    single = mobile['port16'].predict_multimodal(**reqs[0])
    np.testing.assert_allclose(single['fusion']['all_probabilities'],
                               got[0]['fusion']['all_probabilities'],
                               atol=1e-6)


def test_lstm_absent_serves_the_keyword_heuristic_as_jax(mobile):
    """F1: with no Bi-LSTM artifact both engines answer
    predict_texts_lstm with the keyword map."""
    texts = ['I am so happy!', 'this is disgusting', 'hmm', 'WOW']
    assert mobile['jax32'].lstm is None
    assert mobile['port32'].predict_texts_lstm(texts) == \
        mobile['jax32'].predict_texts_lstm(texts)
