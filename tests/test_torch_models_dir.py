"""The port's engine served from a models directory
(EmotionEngine.from_models_dir, get_engine, the inference facades)
against the JAX engine on the same directory.

The directory is the JAX writer's (write_synthetic_artifacts(tiny=True,
image_size=32): speech DNN, tiny BERT with vocab and config, the Bi-LSTM
the port does not serve, ResNet50 at 32 px, the fusion net) plus an
8-tree depth-6 forest fitted by sklearn on the JAX trainer's synthetic
softmax data. The JAX bf16 engine is built first: it calibrates and
caches its int8 scales in the .mecp metas, and the port's bf16 engine
takes them from there (the direction that worked before the port could
write). tests/test_torch_mobilenet.py holds the other direction, the
MobileNetV2 directory and the rf tail in bf16.

Tolerances, each with its reason:

* per-modality probabilities: 1e-4 in fp32 (the port's parity
  contract), 0.05 in bf16 with decisions equal where the JAX confidence
  exceeds 0.6 (tests/test_torch_trimodal_engine.py's band);
* the rf tail, two ways (rf_tail_agreement): within 1e-6 of the forest
  walked on the port's own three softmax outputs (the same leaves, only
  the order of the mean over trees differs); and against the JAX
  engine's: wherever no walk compares an input lying within the
  per-modality tolerance of its threshold, the same leaf per tree and
  the tail within 1e-6. A comparison that near may flip a branch, so
  such walks and rows are counted, not compared;
* the JAX writer's files rewritten by the port's store: identical bytes;
* fallbacks and the copies of host modules: equal.
"""

import logging
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert import hf_bert
from mec_tpu.convert import store as jstore
from mec_tpu.models import forest as jforest
from mec_tpu.serving import engine as jax_engine_module
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu.serving.synthetic_artifacts import write_synthetic_artifacts
from mec_tpu.training.train_fusion import generate_synthetic_data
from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import hf_config, store
from mec_tpu_torch.models.forest import forest_apply, forest_leaves
from mec_tpu_torch.ops import quant, wav
from mec_tpu_torch.serving import engine as engine_module
from mec_tpu_torch.serving import synthetic_artifacts as sa
from mec_tpu_torch.serving.engine import EmotionEngine, get_engine

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 66150
TEXTS = ['i am so happy today', 'this is terrible and sad',
         'wow what a surprise', 'i feel angry about all of this']
ARTIFACTS = ('speech_model.mecp', 'bert_model/bert_model.mecp',
             'text_model.mecp', 'image_model.mecp', 'fusion_model.mecp',
             'fusion_rf.mecp')


def write_forest(models_dir, seed=0):
    """An 8-tree depth-6 forest fitted by sklearn on the JAX trainer's
    synthetic softmax data, converted and written by the JAX package
    (train_fusion_rf.train does the same and also writes a database)."""
    from sklearn.ensemble import RandomForestClassifier
    _sf, _tf, _if, s_p, t_p, i_p, labels = generate_synthetic_data(400, seed)
    x = np.concatenate([s_p, t_p, i_p], axis=1).astype(np.float32)
    rf = RandomForestClassifier(n_estimators=8, max_depth=6,
                                random_state=seed).fit(x, labels)
    arrays, meta = jforest.from_sklearn(rf)
    jstore.save_params(os.path.join(models_dir, 'fusion_rf.mecp'),
                       {'forest': arrays}, meta=meta)
    return rf


def rf_tail_agreement(engine, got, ref, tol):
    """Hold the port's rf tails (`got`, result dicts of `engine`) two
    ways: against the forest walked on their own s/t/i probabilities
    (the port's walk and the JAX package's forest_apply), and against
    the JAX engine's (`ref`): every tree whose walk compares no input
    within `tol` of its threshold parks at the same leaf on the JAX
    engine's s/t/i, and every row whose walks all do so has the JAX
    engine's tail. Returns (rows compared, rows near, trees compared,
    trees near)."""
    arrays = {k: v.cpu().numpy() for k, v in engine.forest['arrays'].items()}
    depth = engine.forest['depth']

    def features(results):
        return np.array([np.concatenate([r[m]['all_probabilities']
                                         for m in ('speech', 'text', 'image')])
                         for r in results], np.float32)

    x, x_ref = features(got), features(ref)
    tails = np.array([r['fusion']['all_probabilities'] for r in got])
    mine = forest_apply(engine.forest['arrays'], torch.from_numpy(x),
                        depth).numpy()
    jax_arrays = {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
                  for k, v in arrays.items()}
    theirs = np.asarray(jforest.forest_apply(jax_arrays, x, depth))
    np.testing.assert_allclose(tails, mine, atol=1e-6, rtol=0)
    np.testing.assert_allclose(tails, theirs, atol=1e-6, rtol=0)
    leaves = [forest_leaves(engine.forest['arrays'], torch.from_numpy(v),
                            depth).numpy() for v in (x, x_ref)]
    rows = [0, 0]
    trees = [0, 0]
    for b, (row, r) in enumerate(zip(got, ref)):
        row_near = False
        for t in range(arrays['feature'].shape[0]):
            n, closest = 0, np.inf
            while arrays['left'][t, n] != n:
                f, thr = arrays['feature'][t, n], arrays['threshold'][t, n]
                closest = min(closest, abs(x[b, f] - thr))
                n = arrays['left' if x[b, f] <= thr else 'right'][t, n]
            if closest <= tol:
                trees[1] += 1
                row_near = True
            else:
                trees[0] += 1
                assert leaves[0][b, t] == leaves[1][b, t], (b, t)
        rows[row_near] += 1
        if not row_near:
            np.testing.assert_allclose(row['fusion']['all_probabilities'],
                                       r['fusion']['all_probabilities'],
                                       atol=1e-6, rtol=0)
    print(f'rf tail (tol {tol}): {rows[0]} rows equal the JAX tail, '
          f'{rows[1]} rows with a comparison that near a threshold; '
          f'{trees[0]} tree walks park at the JAX leaf, {trees[1]} near')
    return (*rows, *trees)


def jax_engine(models_dir, dtype, fusion):
    old = JaxConfig.COMPUTE_DTYPE, JaxConfig.FUSION_MODE
    JaxConfig.COMPUTE_DTYPE, JaxConfig.FUSION_MODE = dtype, fusion
    try:
        return JaxEngine(models_dir=models_dir, mesh=None)
    finally:
        JaxConfig.COMPUTE_DTYPE, JaxConfig.FUSION_MODE = old


def port_engine(models_dir, dtype, fusion):
    old = Config.FUSION_MODE
    Config.FUSION_MODE = fusion
    try:
        return EmotionEngine.from_models_dir(models_dir, compute_dtype=dtype,
                                             device='cpu')
    finally:
        Config.FUSION_MODE = old


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('models'))
    write_synthetic_artifacts(d, tiny=True, image_size=32)
    rf = write_forest(d)
    jax16 = jax_engine(d, 'bfloat16', 'attention')   # caches its scales
    runs = quant.CALIBRATION_RUNS
    port16 = port_engine(d, 'bfloat16', 'attention')
    assert quant.CALIBRATION_RUNS == runs
    files = tmp_path_factory.mktemp('uploads')
    wavs, pngs = [], []
    rng = np.random.RandomState(3)
    t = np.arange(N) / 22050.0
    for i in range(4):
        wavs.append(str(files / f'a{i}.wav'))
        y = (0.05 + 0.1 * i) * np.sin(2 * np.pi * (200 + 150 * i) * t)
        wav.write_wav(wavs[-1], (y + 0.01 * rng.randn(N)).astype(np.float32),
                      22050)
        pngs.append(str(files / f'i{i}.png'))
        Image.fromarray(rng.randint(0, 256, (32, 40, 3), np.uint8)
                        ).save(pngs[-1])
    return {'dir': d, 'rf': rf, 'jax16': jax16, 'port16': port16,
            'jax32': jax_engine(d, 'float32', 'rf'),
            'port32': port_engine(d, 'float32', 'rf'),
            'wavs': wavs, 'pngs': pngs}


def _requests(s, n=4):
    return [{'audio_path': s['wavs'][i], 'text': TEXTS[i],
             'image_path': s['pngs'][i]} for i in range(n)]


# ----------------------------------------------------------------------
# the directory served by both engines
# ----------------------------------------------------------------------

@pytest.mark.parametrize('name', ARTIFACTS)
def test_jax_writer_files_rewrite_to_the_same_bytes(setup, name, tmp_path):
    """Each of the JAX writer's files (and the JAX engine's scale cache
    in their metas) read by the port's store and written back: flax's
    bytes; the JAX package reads the port's reading to equal trees."""
    path = os.path.join(setup['dir'], name)
    with open(path, 'rb') as f:
        want = f.read()
    loaded = store.load_params(path)
    out = str(tmp_path / 'port.mecp')
    store.save_params(out, loaded['variables'], meta=loaded['meta'])
    with open(out, 'rb') as f:
        assert f.read() == want
    if name == 'image_model.mecp':
        assert list(loaded['meta']['int8_scales']) == [
            'image|resnet50|32x32|bfloat16|m1.25|v1']


def test_port_takes_the_jax_engines_scales(setup):
    port = setup['port16']
    assert port._image_scales_cached and port._bert_scales_cached
    assert port._image_quant_mode == port._bert_quant_mode == 'static'
    assert port._image_arch == 'resnet50' and port._fusion_kind == 'attention'


def test_bf16_attention_engine_matches_jax(setup):
    reqs = _requests(setup)
    got = setup['port16'].predict_multimodal_batch(reqs)
    ref = setup['jax16'].predict_multimodal_batch(reqs)
    for g, r in zip(got, ref):
        assert set(g) == {'speech', 'text', 'image', 'fusion'}
        assert 'attention_weights' in g['fusion']
        assert 'method' not in g['fusion']
        for mod in g:
            np.testing.assert_allclose(g[mod]['all_probabilities'],
                                       r[mod]['all_probabilities'],
                                       atol=0.05, err_msg=mod)
            if r[mod]['confidence'] > 0.6:
                assert g[mod]['emotion'] == r[mod]['emotion'], mod


def test_fp32_rf_engine_matches_jax(setup):
    port, jax = setup['port32'], setup['jax32']
    assert port._fusion_kind == jax._fusion_kind == 'rf'
    reqs = _requests(setup)
    got = port.predict_multimodal_batch(reqs)
    ref = jax.predict_multimodal_batch(reqs)
    for g, r in zip(got, ref):
        assert set(g['fusion']) == {'emotion', 'confidence',
                                    'all_probabilities', 'method'}
        assert g['fusion']['method'] == r['fusion']['method'] \
            == 'random_forest'
        for mod in ('speech', 'text', 'image'):
            assert g[mod]['emotion'] == r[mod]['emotion'], mod
            np.testing.assert_allclose(g[mod]['all_probabilities'],
                                       r[mod]['all_probabilities'],
                                       atol=1e-4, err_msg=mod)
    rows, _near, trees, _trees_near = rf_tail_agreement(port, got, ref,
                                                        tol=1e-4)
    assert rows > 0 and trees > 0
    # sklearn on the served softmax outputs (tests/test_forest.py's check)
    x = np.array([np.concatenate([g[m]['all_probabilities']
                                  for m in ('speech', 'text', 'image')])
                  for g in got], np.float32)
    np.testing.assert_allclose([g['fusion']['all_probabilities'] for g in got],
                               setup['rf'].predict_proba(x), atol=1e-6)
    single = port.predict_multimodal(**reqs[1])
    np.testing.assert_allclose(single['fusion']['all_probabilities'],
                               got[1]['fusion']['all_probabilities'],
                               atol=1e-6)
    packed = port._run_trimodal(np.zeros((2, N), np.float32), TEXTS[:2],
                                np.zeros((2, 32, 32, 3), np.uint8))
    assert packed.shape == (2, 28)


def test_lstm_artifact_present_raises_item_10(setup):
    """F1, closed: the directory holds text_model.mecp and its tokenizer;
    both engines serve the Bi-LSTM (the item-10 raise is gone), the port
    within 1e-5 of JAX in fp32 and with JAX's decisions in bf16 (band
    0.05, where JAX's confidence exceeds 0.6)."""
    for dtype, atol in (('32', 1e-5), ('16', 0.05)):
        want = setup['jax' + dtype].predict_texts_lstm(TEXTS)
        got = setup['port' + dtype].predict_texts_lstm(TEXTS)
        assert setup['port' + dtype].lstm is not None
        assert all('_fallback' not in g for g in got)
        np.testing.assert_allclose(
            [g['all_probabilities'] for g in got],
            [w['all_probabilities'] for w in want], rtol=0, atol=atol)
        for g, w in zip(got, want):
            if w['confidence'] > 0.6:
                assert g['emotion'] == w['emotion']


# ----------------------------------------------------------------------
# get_engine and the facades
# ----------------------------------------------------------------------

@pytest.fixture()
def singletons(setup, monkeypatch):
    """The port's singleton built for the CPU in fp32 rf mode; the JAX
    facades' singleton set to the module's fp32 rf JAX engine."""
    monkeypatch.setattr(Config, 'FUSION_MODE', 'rf')
    monkeypatch.setattr(engine_module, '_engine', None)
    monkeypatch.setattr(jax_engine_module, '_engine', setup['jax32'])
    eng = get_engine(setup['dir'], device='cpu')
    yield eng


def test_get_engine_is_a_singleton(singletons, setup):
    assert get_engine() is singletons
    assert get_engine(setup['dir'], device='cuda') is singletons
    fresh = get_engine(setup['dir'], reload=True, device='cpu')
    assert fresh is not singletons and get_engine() is fresh
    assert fresh.device == torch.device('cpu') and fresh._fusion_kind == 'rf'


def test_facades_match_the_jax_facades(singletons, setup):
    import mec_tpu.inference as jinf
    import mec_tpu_torch.inference as tinf
    wav_path, png, text = setup['wavs'][2], setup['pngs'][2], TEXTS[2]
    pairs = [
        (tinf.SpeechInference().predict(wav_path),
         jinf.SpeechInference().predict(wav_path)),
        (tinf.TextInference().predict(text),
         jinf.TextInference().predict(text)),
        (tinf.ImageInference().predict(png), jinf.ImageInference().predict(png)),
    ]
    pairs += zip(tinf.SpeechInference().predict_batch(setup['wavs'][:2]),
                 jinf.SpeechInference().predict_batch(setup['wavs'][:2]))
    for g, r in pairs:
        assert set(g) == set(r) == {'emotion', 'confidence',
                                    'all_probabilities'}
        assert g['emotion'] == r['emotion']
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=1e-4)
    got = tinf.MultimodalFusion().predict_multimodal(wav_path, text, png)
    ref = jinf.MultimodalFusion().predict_multimodal(wav_path, text, png)
    assert got['fusion']['method'] == 'random_forest'
    np.testing.assert_allclose(got['fusion']['all_probabilities'],
                               ref['fusion']['all_probabilities'], atol=1e-4)
    feats, probs = tinf.ImageInference().extract_features(png)
    assert feats.shape == (512,) and probs.shape == (7,)
    feats, _ = tinf.TextInference().extract_features(text)
    assert feats.shape == (64,)
    assert tinf.TextInference().tokenizer is singletons.bert_tokenizer
    # the Bi-LSTM facade (its item-10 raise is gone): the JAX facade's
    # answer within the fp32 contract
    g = tinf.FastTextEmotionPredictor().predict(text)
    r = jinf.FastTextEmotionPredictor().predict(text)
    assert g['emotion'] == r['emotion'] and set(g) == set(r)
    np.testing.assert_allclose(g['all_probabilities'],
                               r['all_probabilities'], atol=1e-4)


def _code_without_docstring_and_imports(path):
    with open(path, encoding='utf-8') as f:
        src = f.read()
    body = src.split('"""', 2)[2]                     # drop module docstring
    return re.sub(r'^\s*from mec_tpu(_torch)?\..*$', '', body, flags=re.M)


@pytest.mark.parametrize('name', [
    '__init__.py', 'speech_inference.py', 'text_inference.py',
    'image_inference.py', 'multimodal_fusion.py', 'text_lstm_inference.py'])
def test_facade_copies_match_originals(name):
    got, ref = (_code_without_docstring_and_imports(
        os.path.join(_REPO, pkg, 'inference', name))
        for pkg in ('mec_tpu_torch', 'mec_tpu'))
    assert got == ref


@pytest.mark.parametrize('cfg', [
    {}, {'vocab_size': 120, 'hidden_size': 64, 'num_hidden_layers': 2,
         'num_attention_heads': 2, 'intermediate_size': 128,
         'max_position_embeddings': 128, 'type_vocab_size': 2,
         'num_labels': 7},
    {'id2label': {'0': 'a', '1': 'b', '2': 'c'}},
    {'num_experts': 4, 'moe_capacity_factor': 2.0}])
def test_hf_config_copy_matches_original(cfg):
    ref = hf_bert.model_kwargs_from_config(cfg)
    assert hf_config.model_kwargs_from_config(cfg) == ref


# ----------------------------------------------------------------------
# the loader's edges (the port's own writer; tiny)
# ----------------------------------------------------------------------

@pytest.fixture(scope='module')
def tiny_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('port_models'))
    sa.write_synthetic_artifacts(d, tiny=True, image_arch='mobilenet_v2',
                                 image_size=32)
    return d


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


@pytest.mark.parametrize('ref_file,native,error', [
    ('speech_model.h5', 'speech_model.mecp', OSError),
    ('speech_scaler.pkl', 'speech_scaler.npz', IndexError),
    ('image_model.pt', 'image_model.mecp', pickle.UnpicklingError),
    ('fusion_model.pt', 'fusion_model.mecp', pickle.UnpicklingError),
    ('bert_model/pytorch_model.bin', 'bert_model/bert_model.mecp',
     pickle.UnpicklingError),
    ('fusion_rf.pkl', 'fusion_rf.mecp', IndexError)])
def test_reference_format_alone_raises_item_21(tiny_dir, tmp_path, ref_file,
                                               native, error, monkeypatch):
    """A reference-format file with no cache beside it is converted at
    load (tests/test_torch_convert.py); one that does not convert (h5py,
    joblib or torch.load refuse its bytes) raises, where the JAX engine
    logs and serves the fallback (C5), and leaves no cache behind."""
    monkeypatch.setattr(Config, 'FUSION_MODE', 'rf')
    d = _copy(tiny_dir, tmp_path / 'm')
    os.remove(os.path.join(d, native))
    with open(os.path.join(d, ref_file), 'wb') as f:
        f.write(b'reference checkpoint')
    with pytest.raises(error):
        EmotionEngine.from_models_dir(d, device='cpu')
    assert not os.path.exists(os.path.join(d, native))


def test_corrupt_mecp_raises(tiny_dir, tmp_path):
    d = _copy(tiny_dir, tmp_path / 'm')
    with open(os.path.join(d, 'fusion_model.mecp'), 'r+b') as f:
        f.truncate(100)
    with pytest.raises(ValueError, match='truncated'):
        EmotionEngine.from_models_dir(d, device='cpu')


def test_missing_artifacts_serve_the_fallbacks(tmp_path, setup):
    """An empty directory: every modality on its fallback, as an engine
    given no trees (whose fallbacks tests/test_torch_*engine.py hold
    against the JAX engine's)."""
    empty = EmotionEngine.from_models_dir(str(tmp_path), device='cpu')
    bare = EmotionEngine(device='cpu')
    assert empty.speech is empty.bert is empty.image is empty.fusion is None
    req = _requests(setup, 1)[0]
    assert empty.predict_multimodal(**req) == bare.predict_multimodal(**req)
    assert empty.predict_texts_lstm(TEXTS) == bare.predict_texts_lstm(TEXTS)


def test_rf_mode_without_forest_serves_attention(tiny_dir, tmp_path,
                                                 monkeypatch, caplog):
    monkeypatch.setattr(Config, 'FUSION_MODE', 'rf')
    d = _copy(tiny_dir, tmp_path / 'm')
    os.remove(os.path.join(d, 'fusion_rf.mecp'))
    with caplog.at_level(logging.WARNING, 'mec_tpu_torch.serving'):
        eng = EmotionEngine.from_models_dir(d, device='cpu')
    assert eng._fusion_kind == 'attention' and eng.forest is None
    assert 'no fusion_rf artifact' in caplog.text


def test_moe_config_raises_item_12(tmp_path):
    """An MoE config.json serves (it raised naming item 12 before the
    port had the MoE BERT): from_models_dir builds the MoE model from
    num_experts and moe_capacity_factor."""
    d = sa.write_synthetic_artifacts(str(tmp_path / 'm'), tiny=True,
                                     image_arch='mobilenet_v2',
                                     image_size=32, bert_experts=2,
                                     moe_capacity_factor=2.0)
    eng = EmotionEngine.from_models_dir(d, device='cpu')
    moe = eng.bert['model'].layer_1.moe
    assert (moe.num_experts, moe.capacity_factor) == (2, 2.0)
    out = eng.predict_texts(TEXTS)
    assert all(len(r['all_probabilities']) == 7 for r in out)


def test_config_paths_without_models_dir(tiny_dir, monkeypatch):
    """models_dir None reads each artifact at its Config path, as the
    JAX engine's _path does."""
    for name, f in (('SPEECH_MODEL_PATH', 'speech_model.h5'),
                    ('SPEECH_SCALER_PATH', 'speech_scaler.pkl'),
                    ('IMAGE_MODEL_PATH', 'image_model.h5'),
                    ('BERT_MODEL_PATH', 'bert_model')):
        monkeypatch.setattr(Config, name, os.path.join(tiny_dir, f))
    monkeypatch.setattr(Config, 'FUSION_MODEL_PATH', '/nonexistent/f.pkl')
    eng = EmotionEngine.from_models_dir(None, device='cpu')
    assert eng.speech and eng.bert and eng.image and eng.fusion is None
    assert eng._image_arch == 'mobilenet_v2' and eng._image_size == (32, 32)


def test_scale_write_back_errors(tiny_dir, tmp_path, monkeypatch, caplog):
    """A directory that cannot be written (OSError) is logged and the
    engine serves with the scales in memory; any other failure raises."""
    d = _copy(tiny_dir, tmp_path / 'm')

    def refuse(*_a, **_k):
        raise OSError(30, 'Read-only file system')

    monkeypatch.setattr(store, 'save_params', refuse)
    with caplog.at_level(logging.WARNING, 'mec_tpu_torch.serving'):
        eng = EmotionEngine.from_models_dir(d, compute_dtype='bfloat16',
                                            device='cpu')
    assert eng._image_quant_mode == eng._bert_quant_mode == 'static'
    assert caplog.text.count('int8 scale cache not persisted') == 2
    assert 'int8_scales' not in store.load_params(
        os.path.join(d, 'image_model.mecp'))['meta']

    def broken(*_a, **_k):
        raise RuntimeError('disk on fire')

    monkeypatch.setattr(store, 'save_params', broken)
    with pytest.raises(RuntimeError, match='disk on fire'):
        EmotionEngine.from_models_dir(d, compute_dtype='bfloat16',
                                      device='cpu')


def test_port_writer_layout(tiny_dir):
    """The port's writer: the JAX writer's file layout (no Bi-LSTM), the
    JAX package's store reads every file."""
    names = sorted(os.path.relpath(os.path.join(r, f), tiny_dir)
                   for r, _d, fs in os.walk(tiny_dir) for f in fs)
    assert names == ['bert_model/bert_model.mecp', 'bert_model/config.json',
                     'bert_model/vocab.txt', 'fusion_model.mecp',
                     'fusion_rf.mecp', 'image_model.mecp',
                     'speech_model.mecp', 'speech_scaler.npz']
    image = jstore.load_params(os.path.join(tiny_dir, 'image_model.mecp'))
    assert image['meta'] == {'arch': 'mobilenet_v2', 'img_size': 32}
    rf = jstore.load_params(os.path.join(tiny_dir, 'fusion_rf.mecp'))
    assert rf['meta']['depth'] == 6
    assert rf['variables']['forest']['feature'].shape[0] == 8
