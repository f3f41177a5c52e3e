"""Serving data parallelism in the port's engine (EmotionEngine(mesh=...),
the JAX engine's mesh, mec_tpu/serving/engine.py:112-127, 515-519)
against one device and against the JAX engine on its eight virtual CPU
devices.

The port writer's tiny directory (speech DNN, 2-layer BERT, ResNet50 at
32 px, fusion net; and a seeded Bi-LSTM with its tokenizer) is served by
the port on the CPU with mesh=None and with mesh=['cpu', 'cpu'] (two
replicas, each a copy of the first's calibrated models). The speech
scaler is fitted to the test clips' features, as the speech trainer
fits it: with the writer's identity scaler the raw features (up to
~9,000) drive the tiny DNN's logits to ~800, where the split's relative
rounding of 4e-7 moves a probability by 5e-5. Tolerances, each with
its reason:

* buckets: equal to the JAX engine's rounding at 2 and 8 devices;
* fp32, every route (tri-modal, speech, text, image, Bi-LSTM) against
  mesh=None: probabilities within 1e-5 (MULTICHIP_r05's JAX check;
  measured <= 1.5e-07), features within 1e-5 of their largest magnitude
  (measured <= 1.8e-07): the replicas' smaller matmuls sum in another
  order;
* bf16, the same routes: each replica's rows bit for bit equal to the
  single-device engine's step fed the same rows at the same per-replica
  bucket (the split is exact), and the whole result against mesh=None
  within 2e-3 (measured 0 here, 7.4e-04 on the tri-modal rows with the
  identity scaler: the CPU's bf16 matmuls may round differently at
  another batch size);
* the port over mesh=['cpu'] * 8 against the JAX engine over its eight
  devices (mesh='auto'), fp32 tri-modal requests: 1e-4, the port's
  parity contract.
"""

import numpy as np
import pytest
import torch

from mec_tpu.config import Config as JaxConfig
from mec_tpu.serving import engine as jengine
from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.models.bilstm import BiLSTMTextModel
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.serving import engine as pengine
from mec_tpu_torch.serving.synthetic_artifacts import \
    write_synthetic_artifacts
from mec_tpu_torch.text.keras_tokenizer import KerasTokenizer
from mec_tpu_torch.serving.engine import EmotionEngine, resolve_mesh
from mec_tpu_torch.training.common import flax_init

N = 66150
TEXTS = ['i am so happy today', 'this is terrible and sad',
         'wow what a surprise', 'i feel angry about all of this',
         'calm sea and a quiet day']



@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """Six tier-1 workers share the CPU: two torch threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    torch.manual_seed(0)
    d = str(tmp_path_factory.mktemp('models'))
    write_synthetic_artifacts(d, tiny=True, image_size=32)
    store.save_params(f'{d}/text_model.mecp', to_jax(flax_init(
        BiLSTMTextModel(vocab_size=100, embed_dim=16, lstm_units=(12, 8),
                        dense_units=(16, 8)), 0)))
    tok = KerasTokenizer(num_words=100)
    tok.fit_on_texts(TEXTS)
    tok.to_json_file(f'{d}/text_model_tokenizer.json')
    rng = np.random.RandomState(3)
    t = np.arange(N) / 22050.0
    waves = np.stack([(0.05 + 0.1 * i) * np.sin(2 * np.pi * (200 + 150 * i)
                                                 * t) + 0.01 * rng.randn(N)
                      for i in range(5)]).astype(np.float32)
    imgs = rng.randint(0, 256, (5, 32, 32, 3)).astype(np.uint8)
    feats = af.audio_features_56(torch.from_numpy(waves), 'parity').numpy()
    np.savez(f'{d}/speech_scaler.npz', mean=feats.mean(0),
             scale=feats.std(0) + 1e-6)
    engines = {}
    for dtype in ('float32', 'bfloat16'):
        for name, mesh in (('one', None), ('two', ['cpu', 'cpu'])):
            engines[name, dtype] = EmotionEngine.from_models_dir(
                d, compute_dtype=dtype, device='cpu', mesh=mesh)
    return {'dir': d, 'engines': engines, 'waves': waves, 'imgs': imgs}


@pytest.mark.parametrize('d', [2, 8])
def test_bucket_rounds_like_jax(d):
    eng = EmotionEngine(device='cpu', mesh=['cpu'] * d)
    assert len(eng.replicas) == d
    for n in range(1, 70):
        b = jengine._bucket_for(n)
        assert eng._bucket(n) == -(-b // d) * d


def _route(eng, route, s):
    """The packed rows of one route for the setup's five inputs."""
    w, im = s['waves'], s['imgs']
    if route == 'trimodal':
        return eng._run_trimodal(w, TEXTS, im)
    if route == 'speech':
        return np.concatenate(eng._run_speech(w), axis=1)
    if route == 'image':
        return np.concatenate(eng._run_image(im), axis=1)
    if route == 'text':
        out = eng.predict_texts(TEXTS, want_features=True)
        return np.array([np.concatenate([r['all_probabilities'],
                                         r['_features']]) for r in out])
    return np.array([r['all_probabilities']
                     for r in eng.predict_texts_lstm(TEXTS)])


ROUTES = ['trimodal', 'speech', 'text', 'image', 'lstm']


@pytest.mark.parametrize('route', ROUTES)
def test_fp32_replicas_match_one_device(setup, route):
    e = setup['engines']
    assert e['two', 'float32'].lstm is not None
    one = _route(e['one', 'float32'], route, setup)
    two = _route(e['two', 'float32'], route, setup)
    assert one.shape == two.shape
    probs = 34 if route == 'trimodal' else 7
    np.testing.assert_allclose(two[:, :probs], one[:, :probs], atol=1e-5,
                               rtol=0)
    scale = max(float(np.abs(one[:, probs:]).max()), 1.0) \
        if one.shape[1] > probs else 1.0
    np.testing.assert_allclose(two[:, probs:], one[:, probs:],
                               atol=1e-5 * scale, rtol=0)


def _wires(eng, route, s, b):
    w, im = s['waves'], s['imgs']
    if route == 'trimodal':
        return (eng._wire_waves(w, b), *eng._text_wire(TEXTS, b),
                eng._wire_image(im, b))
    if route == 'speech':
        return (eng._wire_waves(w, b),)
    if route == 'image':
        return (eng._wire_image(im, b),)
    if route == 'text':
        return eng._text_wire(TEXTS, b)
    return (pengine._pad_rows(eng.lstm_tokenizer.encode_batch(
        [t.lower().strip() for t in TEXTS], pengine.Config.MAX_TEXT_LENGTH),
        b),)


STEPS = {'trimodal': '_trimodal_forward', 'speech': '_speech_forward',
         'image': '_image_forward', 'text': '_text_forward',
         'lstm': '_lstm_forward'}


@pytest.mark.parametrize('route', ROUTES)
def test_bf16_replica_rows_are_exact(setup, route):
    e = setup['engines']
    one, two = e['one', 'bfloat16'], e['two', 'bfloat16']
    b = two._bucket(5)
    assert b == 8
    wires = _wires(two, route, setup, b)
    got = two._run(STEPS[route], *wires)
    per = b // 2
    for r in range(2):
        block = [tuple(x[r * per:(r + 1) * per] for x in a)
                 if isinstance(a, tuple) else a[r * per:(r + 1) * per]
                 for a in wires]
        dev = [one._to_device(a) if isinstance(a, tuple)
               else one._to_device((a,))[0] for a in block]
        with torch.inference_mode():
            want = getattr(one, STEPS[route])(*dev).numpy()
        np.testing.assert_array_equal(got[r * per:(r + 1) * per], want)
    whole = _route(one, route, setup)
    probs = 34 if route == 'trimodal' else 7
    np.testing.assert_allclose(_route(two, route, setup)[:, :probs],
                               whole[:, :probs], atol=2e-3, rtol=0)


def test_eight_replicas_match_the_jax_engine_on_eight_devices(setup,
                                                              monkeypatch):
    monkeypatch.setattr(JaxConfig, 'COMPUTE_DTYPE', 'float32')
    jax_eng = jengine.EmotionEngine(models_dir=setup['dir'], mesh='auto')
    assert jax_eng._data_size == 8
    port = EmotionEngine.from_models_dir(setup['dir'], compute_dtype='float32',
                                         device='cpu', mesh=['cpu'] * 8)
    assert port._bucket(4) == jax_eng._bucket(4) == 8
    reqs = [{'audio_path': 'a.wav', 'text': TEXTS[i],
             'image_path': 'i.png', 'wave': setup['waves'][i],
             'image': setup['imgs'][i]} for i in range(4)]
    got = port.predict_multimodal_batch(reqs)
    want = jax_eng.predict_multimodal_batch(reqs)
    for g, w in zip(got, want):
        for mod in ('speech', 'text', 'image', 'fusion'):
            np.testing.assert_allclose(g[mod]['all_probabilities'],
                                       w[mod]['all_probabilities'],
                                       atol=1e-4, err_msg=mod)
            assert g[mod]['emotion'] == w[mod]['emotion']


def test_mesh_resolution(monkeypatch):
    cpu = torch.device('cpu')
    assert resolve_mesh(None, cpu) == [cpu]
    assert resolve_mesh('auto', cpu) == [cpu]
    assert resolve_mesh(['cpu', 'cpu'], cpu) == [cpu, cpu]
    with pytest.raises(ValueError, match="expected 'auto'"):
        resolve_mesh('all', cpu)
    if not torch.cuda.is_available():
        # no silent shrink: a card that is not there raises
        with pytest.raises(RuntimeError, match='never shrunk'):
            resolve_mesh(['cuda:0', 'cuda:1'], cpu)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    monkeypatch.setattr(pengine.Config, 'MESH_DATA', 'auto')
    monkeypatch.setattr(pengine.Config, 'MESH_MODEL', 1)
    cuda = torch.device('cuda')
    assert resolve_mesh('auto', cuda) == [torch.device('cuda', i)
                                          for i in range(4)]
    assert resolve_mesh(None, cuda) == [cuda]
    # a model column's cards would compute the same rows: the first of
    # each data row serves (JAX replicates the params over 'model')
    monkeypatch.setattr(pengine.Config, 'MESH_MODEL', 2)
    assert resolve_mesh('auto', cuda) == [torch.device('cuda', 0),
                                          torch.device('cuda', 2)]


def test_auto_mesh_keeps_a_named_card(monkeypatch, tmp_path):
    """Serving on several cards is asked for (mesh='auto' or a list): the
    three entry points serve one device by default, 'auto' keeps a card
    named by its index, and the fusion trainer's feature engine serves
    its rank's card alone."""
    import inspect

    from mec_tpu_torch.training import train_fusion
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    monkeypatch.setattr(pengine.Config, 'MESH_DATA', 'auto')
    monkeypatch.setattr(pengine.Config, 'MESH_MODEL', 1)
    for i in range(4):
        card = torch.device('cuda', i)
        assert resolve_mesh('auto', card) == [card]
    for fn in (EmotionEngine.__init__, EmotionEngine.from_models_dir,
               pengine.get_engine):
        assert inspect.signature(fn).parameters['mesh'].default is None
    seen = {}

    def from_models_dir(models_dir, **kw):
        seen.update(kw)
        raise SystemExit('stop')

    monkeypatch.setattr(EmotionEngine, 'from_models_dir', from_models_dir)
    manifest = tmp_path / 'm.csv'
    manifest.write_text('audio_path,text,image_path,label\n'
                        'a.wav,happy day,a.png,happy\n')
    with pytest.raises(SystemExit, match='stop'):
        train_fusion.extract_real_features(str(manifest), verbose=False,
                                           device='cuda:1')
    assert seen == {'device': 'cuda:1', 'mesh': None}
