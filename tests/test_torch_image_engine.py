"""The port's image serving slice (mec_tpu_torch) against the JAX engine.

Both engines get the same full-width ResNet50 tree, made from a numpy
seed at img_size 32. The JAX EmotionEngine reads it from a models/
directory holding only image_model.mecp (meta {'img_size': 32}); the
port's engine takes the numpy tree directly and runs on device='cpu'
(the kernels' plain versions). Tolerances, each with its reason:

* fp32 parity mode (live BN, raw uint8 wire): probabilities and the
  512-dim feature within 1e-4, the port's parity contract;
* bf16 int8-static mode (YUV wire, BN folded, 52 int8 convs): the port
  reads the static scales the JAX engine calibrated and wrote into the
  .mecp meta, so both quantize with the same scales. Decisions must be
  equal where the JAX confidence exceeds 0.6 (tests/test_quant.py's
  rule), probabilities within 0.02, the 0.05 band of
  tests/test_quant.py tightened for the measured 8.9e-4: under
  jax.jit XLA contracts the int8 dequant into an FMA and the bf16 stem
  and head GEMMs accumulate in other orders, so a few activations
  round one bf16 step apart and move an int8 code;
* batch invariance (3 x batch 1 against one batch of 3): 1e-6.

Also here: predict_image_paths on PNGs and its whole-batch fallback on a
bad file, the neutral fallback with no image model, the batcher's image
lane, and /api/predict/image through the unchanged web app.
"""

import io
import os
import threading

import numpy as np
import pytest
from PIL import Image

from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert import store
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu_torch.ops import quant
from mec_tpu_torch.serving.batcher import EngineBatcher
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import image_variables

SIZE = 32


def _imgs():
    rng = np.random.RandomState(11)
    h = w = SIZE
    yy = np.broadcast_to(np.linspace(0, 255, h)[:, None, None], (h, w, 3))
    xx = np.broadcast_to(np.linspace(0, 255, w)[None, :, None], (h, w, 3))
    frames = [rng.randint(0, 256, (h, w, 3)), rng.randint(96, 160, (h, w, 3)),
              yy, xx, np.full((h, w, 3), 255), np.zeros((h, w, 3)),
              np.full((h, w, 3), [255, 0, 0]), np.full((h, w, 3), [0, 0, 255]),
              ((np.indices((h, w)).sum(0) // 4) % 2 * 255)[:, :, None]
              * np.ones(3)]
    return np.stack(frames).astype(np.uint8)


def _jax_engine(models_dir, dtype):
    old = JaxConfig.COMPUTE_DTYPE
    JaxConfig.COMPUTE_DTYPE = dtype
    try:
        return JaxEngine(models_dir=models_dir, mesh=None)
    finally:
        JaxConfig.COMPUTE_DTYPE = old


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """One JAX and one port engine per mode over the same tree."""
    tree, meta = image_variables(seed=6, image_size=SIZE)
    models = tmp_path_factory.mktemp('models')
    nat = store.native_path(str(models / 'image_model.pt'))
    store.save_params(nat, tree, meta=meta)
    jax32 = _jax_engine(str(models), 'float32')
    jax16 = _jax_engine(str(models), 'bfloat16')
    assert jax16._image_quant_mode == 'static' and jax16.speech is None
    cached = store.load_params(nat)['meta']     # holds JAX's int8 scales
    assert 'int8_scales' in cached
    runs = quant.CALIBRATION_RUNS
    port16 = EmotionEngine(image_variables=tree, image_meta=cached,
                           compute_dtype='bfloat16', device='cpu')
    assert quant.CALIBRATION_RUNS == runs and port16._image_scales_cached
    port32 = EmotionEngine(image_variables=tree, image_meta=meta,
                           compute_dtype='float32', device='cpu')
    return {'imgs': _imgs(), 'jax32': jax32, 'jax16': jax16,
            'port32': port32, 'port16': port16}


def _png(tmp_path, name, img):
    path = str(tmp_path / name)
    Image.fromarray(img).save(path)
    return path


def test_fp32_engine_matches_jax_engine(setup):
    imgs = setup['imgs']
    ref = setup['jax32'].predict_images(imgs, want_features=True)
    got = setup['port32'].predict_images(imgs, want_features=True)
    assert len(got) == len(ref) == len(imgs)
    for g, r in zip(got, ref):
        assert '_fallback' not in g and g['_features'].shape == (512,)
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=1e-4)
        np.testing.assert_allclose(g['_features'], r['_features'], atol=1e-4)
        p = np.sort(r['all_probabilities'])
        if p[-1] - p[-2] > 1e-3:
            assert g['emotion'] == r['emotion']
    assert len({g['emotion'] for g in got}) > 1   # the weights discriminate


def test_bf16_int8_static_engine_matches_jax_engine(setup):
    port = setup['port16']
    assert port._image_folded and port._image_quant
    assert port._image_quant_mode == 'static'
    imgs = setup['imgs']
    assert len(port._wire_image(imgs, 16)) == 2          # YUV 4:2:0
    ref = setup['jax16'].predict_images(imgs)
    got = port.predict_images(imgs)
    confident = 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=0.02)
        if r['confidence'] > 0.6:
            confident += 1
            assert g['emotion'] == r['emotion']
    assert confident >= 1


def test_batch_invariance(setup):
    port = setup['port16']
    imgs = setup['imgs'][:3]
    batched = port.predict_images(imgs)
    for i in range(3):
        single = port.predict_images(imgs[i:i + 1])[0]
        np.testing.assert_allclose(single['all_probabilities'],
                                   batched[i]['all_probabilities'], atol=1e-6)


def test_image_paths_and_whole_batch_fallback(setup, tmp_path):
    port = setup['port16']
    imgs = setup['imgs'][:2]
    paths = [_png(tmp_path, f'i{i}.png', im) for i, im in enumerate(imgs)]
    got = port.predict_image_paths(paths, want_features=True)
    direct = port.predict_images(imgs, want_features=True)
    for g, d in zip(got, direct):
        assert g['emotion'] == d['emotion'] and '_fallback' not in g
        np.testing.assert_allclose(g['all_probabilities'],
                                   d['all_probabilities'], atol=1e-6)
    bad = str(tmp_path / 'bad.png')
    with open(bad, 'wb') as f:
        f.write(b'not an image')
    out = port.predict_image_paths([paths[0], bad])
    assert all(r['_fallback'] and r['emotion'] == 'neutral' for r in out)
    assert out == [port.image_fallback()] * 2


def test_no_image_model_serves_the_neutral_fallback(tmp_path):
    jax_engine = JaxEngine(models_dir=str(tmp_path), mesh=None)
    port = EmotionEngine(device='cpu')
    imgs = np.zeros((2, SIZE, SIZE, 3), np.uint8)
    assert port.predict_images(imgs) == jax_engine.predict_images(imgs)
    assert port.predict_image_paths(['x.png']) == \
        jax_engine.predict_image_paths(['x.png'])
    assert port.predict_images(imgs)[0]['all_probabilities'][6] == \
        pytest.approx(0.9)


def test_port_batcher_coalesces_image_requests(setup, tmp_path):
    port = setup['port16']
    paths = [_png(tmp_path, f'b{i}.png', im)
             for i, im in enumerate(setup['imgs'][:4])]
    direct = port.predict_image_paths(paths)
    batcher = EngineBatcher(port, timeout_s=0.05)
    results = [None] * 4
    try:
        threads = [threading.Thread(
            target=lambda i=i: results.__setitem__(
                i, batcher.image.submit(paths[i])))
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
    assert batcher.stats()['image']['items'] == 4


def test_port_engine_serves_image_route_of_unchanged_webapp(setup, tmp_path):
    from werkzeug.test import Client
    from mec_tpu.database import Database
    from mec_tpu.webapp.app import create_app
    os.environ['UPLOAD_FOLDER'] = str(tmp_path / 'uploads')
    JaxConfig.UPLOAD_FOLDER = str(tmp_path / 'uploads')
    port = setup['port16']
    app = create_app(db=Database(str(tmp_path / 'web.db')), engine=port,
                     testing=True)
    path = _png(tmp_path, 'req.png', setup['imgs'][2])
    with open(path, 'rb') as f:
        body = f.read()
    try:
        r = Client(app).post('/api/predict/image',
                             data={'image': (io.BytesIO(body), 'req.png')})
    finally:
        if app._batcher is not None:
            app._batcher.stop()
    assert r.status_code == 200
    want = port.predict_image_paths([path])[0]
    assert r.json['emotion'] == want['emotion']
    assert set(r.json) == {'emotion', 'confidence', 'all_probabilities'}
    np.testing.assert_allclose(r.json['all_probabilities'],
                               want['all_probabilities'], atol=1e-6)
