"""The port's checkpoint converters (mec_tpu_torch/convert/) against the
JAX package's, and a reference-format models directory served by both
engines.

The reference directory is built here from seeds in the reference
trainers' formats, as tests/test_model_parity.py and
tests/test_forest.py build theirs: the speech DNN and the Bi-LSTM as
Keras .h5 (tensorflow, imported in this file only), the scaler and the
forest as joblib pickles of fitted sklearn objects, the Keras tokenizer
as a pickle, MobileNetV2 (served) and ResNet50 (converted only) and the
fusion net as torch .pt state dicts (tests/torch_oracles.py), and a
tiny BERT through transformers' save_pretrained (model.safetensors; a
pytorch_model.bin copy beside it for the other reader).

Tolerances, each with its reason:

* converted trees, .mecp files and tokenizer .json: equal (same code on
  the same bytes; .npz files as arrays, since zip timestamps differ);
* the served directory against the JAX engine on the same directory:
  1e-4 in fp32 (the port's parity contract), the Bi-LSTM 1e-5 (as
  tests/test_torch_models_dir.py holds it); bf16 within 0.05 with
  decisions equal where the JAX confidence exceeds 0.6, that file's
  bands, the port taking the JAX engine's cached int8 scales.
"""

import os
import pickle
import shutil
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert import __main__ as jconvert_main
from mec_tpu.convert import hf_bert as jhf_bert
from mec_tpu.convert import keras_h5 as jkeras_h5
from mec_tpu.convert import sklearn_rf as jsklearn_rf
from mec_tpu.convert import torch_pt as jtorch_pt
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu.text.keras_tokenizer import KerasTokenizer as JaxKerasTokenizer
from mec_tpu_torch.__main__ import main as cli_main
from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import __main__ as convert_main
from mec_tpu_torch.convert import (hf_bert, keras_h5, sklearn_rf, store,
                                   torch_pt)
from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.ops import wav
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import make_vocab
from mec_tpu_torch.text.keras_tokenizer import KerasTokenizer
from mec_tpu_torch.training import train_text_bert

N = 66150
TEXTS = ['i am so happy today', 'this is terrible and sad',
         'wow what a surprise', 'i feel angry about all of this']
BERT_HIDDEN = 32
FUSION_HIDDEN = 32
# every file convert_all writes from the reference directory
CONVERTED = ('speech_model.mecp', 'speech_scaler.npz', 'text_model.mecp',
             'text_model_tokenizer.json', 'image_model.mecp',
             'fusion_model.mecp', 'fusion_rf.mecp',
             'bert_model/bert_model.mecp')


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tier-1 run has six workers on the CPU: torch's default of one
    thread a core in each of them makes them spin on each other, so this
    file keeps torch at two threads and restores the count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# the reference directory
# ----------------------------------------------------------------------

def _keras_speech(path):
    """The reference speech DNN (train_speech_model.py:53-103), with
    moving statistics drawn from a seed so the BN conversion matters."""
    from tensorflow import keras
    keras.utils.set_random_seed(0)
    layers = [keras.layers.Input(shape=(56,))]
    for width, drop in zip((512, 512, 256, 128, 64),
                           (0.4, 0.4, 0.3, 0.2, 0.1)):
        layers += [keras.layers.Dense(width),
                   keras.layers.BatchNormalization(),
                   keras.layers.Activation('relu'),
                   keras.layers.Dropout(drop)]
    layers.append(keras.layers.Dense(7, activation='softmax'))
    km = keras.Sequential(layers)
    rng = np.random.RandomState(4)
    for lyr in km.layers:
        if isinstance(lyr, keras.layers.BatchNormalization):
            w = lyr.get_weights()
            w[2] = rng.randn(*w[2].shape) * 0.5
            w[3] = np.abs(rng.randn(*w[3].shape)) + 0.5
            lyr.set_weights(w)
    km.save(path)


def _keras_lstm(path, vocab_size):
    """The reference Bi-LSTM layout (train_lstm_text_model.py:187-225)."""
    from tensorflow import keras
    keras.utils.set_random_seed(1)
    km = keras.Sequential([
        keras.layers.Input(shape=(Config.MAX_TEXT_LENGTH,)),
        keras.layers.Embedding(vocab_size, 8),
        keras.layers.SpatialDropout1D(0.3),
        keras.layers.Bidirectional(
            keras.layers.LSTM(12, return_sequences=True)),
        keras.layers.Bidirectional(keras.layers.LSTM(6)),
        keras.layers.Dense(10, activation='relu'),
        keras.layers.Dropout(0.5),
        keras.layers.Dense(5, activation='relu'),
        keras.layers.Dropout(0.3),
        keras.layers.Dense(7, activation='softmax'),
    ])
    km.save(path)


def _fit_scaler(path):
    import joblib
    from sklearn.preprocessing import StandardScaler
    rng = np.random.RandomState(5)
    x = rng.randn(64, 56) * rng.uniform(0.5, 40.0, 56) + rng.randn(56) * 10
    joblib.dump(StandardScaler().fit(x), path)


def _fit_forest(path):
    import joblib
    from sklearn.ensemble import RandomForestClassifier
    rng = np.random.RandomState(6)
    x = rng.dirichlet(np.ones(7), (300, 3)).reshape(300, 21)
    y = np.argmax(x[:, :7] + x[:, 7:14] + x[:, 14:], axis=1)
    rf = RandomForestClassifier(n_estimators=6, max_depth=5,
                                random_state=0).fit(x.astype(np.float32), y)
    joblib.dump(rf, path)


def _hf_bert(model_dir, safetensors):
    from transformers import BertConfig
    from transformers import BertForSequenceClassification as HFBert
    vocab = make_vocab()
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=BERT_HIDDEN,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64, max_position_embeddings=160,
                     num_labels=7)
    torch.manual_seed(2)
    HFBert(cfg).eval().save_pretrained(model_dir,
                                       safe_serialization=safetensors)
    with open(os.path.join(model_dir, 'vocab.txt'), 'w') as f:
        f.write('\n'.join(sorted(vocab, key=vocab.get)) + '\n')


def build_reference_dir(d):
    """A models directory in the reference formats only (no .mecp), plus
    extra/ with the ResNet50 .pt and the pytorch_model.bin BERT, which
    are converted but not served."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from tests.torch_oracles import (OracleFusionModel,
                                     OracleImageEmotionModel,
                                     OracleMobileNetEmotionModel,
                                     seeded_state_dict)
    os.makedirs(os.path.join(d, 'extra'))
    _keras_speech(os.path.join(d, 'speech_model.h5'))
    _fit_scaler(os.path.join(d, 'speech_scaler.pkl'))
    words = sorted({w for t in TEXTS for w in t.split()})
    _keras_lstm(os.path.join(d, 'text_model.h5'), len(words) + 2)
    tok = types.SimpleNamespace(
        num_words=len(words) + 2, oov_token='<OOV>', lower=True, split=' ',
        filters='!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n',
        word_index={w: i + 1 for i, w in enumerate(['<OOV>'] + words)})
    with open(os.path.join(d, 'text_model_tokenizer.pkl'), 'wb') as f:
        pickle.dump(tok, f)
    mobile = OracleMobileNetEmotionModel()
    torch.save(seeded_state_dict(mobile), os.path.join(d, 'image_model.pt'))
    torch.save(seeded_state_dict(OracleImageEmotionModel()),
               os.path.join(d, 'extra', 'image_model.pt'))
    torch.manual_seed(3)
    fusion = OracleFusionModel(td=BERT_HIDDEN, hidden=FUSION_HIDDEN)
    torch.save({'model_state_dict': fusion.state_dict(),
                'config': {'speech_dim': 64, 'text_dim': BERT_HIDDEN,
                           'image_dim': 512, 'num_classes': 7,
                           'hidden_dim': FUSION_HIDDEN}},
               os.path.join(d, 'fusion_model.pt'))
    _fit_forest(os.path.join(d, 'fusion_rf.pkl'))
    _hf_bert(os.path.join(d, 'bert_model'), safetensors=True)
    _hf_bert(os.path.join(d, 'extra', 'bert_bin'), safetensors=False)


@pytest.fixture(scope='module')
def ref_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('reference') / 'models')
    build_reference_dir(d)
    return d


def assert_same_tree(got, want, where='tree'):
    """Leaf for leaf: the same keys, and arrays of the same dtype, shape
    and values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            assert_same_tree(got[k], want[k], f'{where}/{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f'{where}[{i}]')
    elif isinstance(want, np.ndarray) or hasattr(want, 'dtype'):
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, where
        np.testing.assert_array_equal(g, w, err_msg=where)
    else:
        assert got == want and type(got) is type(want), where


# ----------------------------------------------------------------------
# the converters, leaf for leaf
# ----------------------------------------------------------------------

@pytest.mark.parametrize('what', [
    'speech_h5', 'lstm_h5', 'scaler', 'mobilenet_pt', 'resnet50_pt',
    'fusion_pt', 'fusion_config', 'bert_safetensors', 'bert_bin', 'forest'])
def test_converted_tree_equals_jax(ref_dir, what):
    p = lambda *f: os.path.join(ref_dir, *f)  # noqa: E731
    port, jax, path = {
        'speech_h5': (keras_h5.convert_speech_h5,
                      jkeras_h5.convert_speech_h5, p('speech_model.h5')),
        'lstm_h5': (keras_h5.convert_lstm_text_h5,
                    jkeras_h5.convert_lstm_text_h5, p('text_model.h5')),
        'scaler': (keras_h5.load_sklearn_scaler,
                   jkeras_h5.load_sklearn_scaler, p('speech_scaler.pkl')),
        'mobilenet_pt': (torch_pt.convert_image_pt,
                         jtorch_pt.convert_image_pt, p('image_model.pt')),
        'resnet50_pt': (torch_pt.convert_image_pt,
                        jtorch_pt.convert_image_pt,
                        p('extra', 'image_model.pt')),
        'fusion_pt': (torch_pt.convert_fusion_pt,
                      jtorch_pt.convert_fusion_pt, p('fusion_model.pt')),
        'fusion_config': (torch_pt.fusion_config_from_pt,
                          jtorch_pt.fusion_config_from_pt,
                          p('fusion_model.pt')),
        'bert_safetensors': (hf_bert.convert_bert_dir,
                             jhf_bert.convert_bert_dir, p('bert_model')),
        'bert_bin': (hf_bert.convert_bert_dir, jhf_bert.convert_bert_dir,
                     p('extra', 'bert_bin')),
        'forest': (sklearn_rf.convert_fusion_rf,
                   jsklearn_rf.convert_fusion_rf, p('fusion_rf.pkl')),
    }[what]
    got, want = port(path), jax(path)
    assert_same_tree(got, want, what)
    if what == 'mobilenet_pt':
        assert 'conv_stem' in got['params']
    if what == 'bert_safetensors':
        assert not os.path.exists(p('bert_model', 'pytorch_model.bin'))


def test_keras_tokenizer_pickle_converts_to_the_same_json(ref_dir,
                                                          tmp_path):
    pkl = os.path.join(ref_dir, 'text_model_tokenizer.pkl')
    KerasTokenizer.from_keras_pickle(pkl).to_json_file(
        str(tmp_path / 'port.json'))
    JaxKerasTokenizer.from_keras_pickle(pkl).to_json_file(
        str(tmp_path / 'jax.json'))
    assert (tmp_path / 'port.json').read_bytes() == \
        (tmp_path / 'jax.json').read_bytes()


@pytest.fixture(scope='module')
def converted(ref_dir, tmp_path_factory):
    """convert_all of each package on its own copy of the directory."""
    out = {}
    for name, fn in (('port', convert_main.convert_all),
                     ('jax', jconvert_main.convert_all)):
        d = str(tmp_path_factory.mktemp(name) / 'models')
        shutil.copytree(ref_dir, d, ignore=shutil.ignore_patterns('extra'))
        before = _files(d)
        assert fn(d) == 6
        out[name] = (d, sorted(_files(d) - before))
    return out


def _files(d):
    return {os.path.relpath(os.path.join(r, f), d)
            for r, _dirs, fs in os.walk(d) for f in fs}


def test_convert_all_writes_the_jax_files(converted):
    assert converted['port'][1] == converted['jax'][1] == sorted(CONVERTED)


@pytest.mark.parametrize('name', CONVERTED)
def test_converted_files_equal_jax(converted, name):
    got = os.path.join(converted['port'][0], name)
    want = os.path.join(converted['jax'][0], name)
    if name.endswith('.npz'):
        with np.load(got) as g, np.load(want) as w:
            assert sorted(g.files) == sorted(w.files)
            for k in w.files:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
        return
    with open(got, 'rb') as g, open(want, 'rb') as w:
        assert g.read() == w.read()


def test_cli_convert(ref_dir, tmp_path, capsys):
    """python -m mec_tpu_torch convert --models-dir DIR (in process)."""
    d = str(tmp_path / 'models')
    shutil.copytree(ref_dir, d, ignore=shutil.ignore_patterns('extra'))
    assert cli_main(['convert', '--models-dir', d]) == 0
    out = capsys.readouterr().out
    assert out.count('converted ') == 8, out
    assert _files(d) >= set(CONVERTED)
    empty = tmp_path / 'empty'
    empty.mkdir()
    assert cli_main(['convert', '--models-dir', str(empty)]) == 0
    assert 'no reference artifacts found' in capsys.readouterr().out


# ----------------------------------------------------------------------
# a reference-format directory served by both engines
# ----------------------------------------------------------------------

def _jax_engine(d, dtype):
    old = JaxConfig.COMPUTE_DTYPE, JaxConfig.FUSION_MODE
    JaxConfig.COMPUTE_DTYPE, JaxConfig.FUSION_MODE = dtype, 'rf'
    try:
        return JaxEngine(models_dir=d, mesh=None)
    finally:
        JaxConfig.COMPUTE_DTYPE, JaxConfig.FUSION_MODE = old


def _port_engine(d, dtype):
    old = Config.FUSION_MODE
    Config.FUSION_MODE = 'rf'
    try:
        return EmotionEngine.from_models_dir(d, compute_dtype=dtype,
                                             device='cpu')
    finally:
        Config.FUSION_MODE = old


@pytest.fixture(scope='module')
def served(ref_dir, tmp_path_factory):
    """Each engine converts its own copy at load; the JAX bf16 engine
    then caches its int8 scales in its copy's metas, and the port's bf16
    engine is built on that copy after it, as
    tests/test_torch_models_dir.py does."""
    dirs = {}
    for name in ('port', 'jax'):
        dirs[name] = str(tmp_path_factory.mktemp(name) / 'models')
        shutil.copytree(ref_dir, dirs[name],
                        ignore=shutil.ignore_patterns('extra'))
    before = _files(dirs['port'])
    port32 = _port_engine(dirs['port'], 'float32')
    written = sorted(_files(dirs['port']) - before)
    jax32 = _jax_engine(dirs['jax'], 'float32')
    jax16 = _jax_engine(dirs['jax'], 'bfloat16')
    port16 = _port_engine(dirs['jax'], 'bfloat16')
    files = tmp_path_factory.mktemp('uploads')
    reqs = []
    rng = np.random.RandomState(3)
    t = np.arange(N) / 22050.0
    for i in range(4):
        wp, pp = str(files / f'a{i}.wav'), str(files / f'i{i}.png')
        y = (0.05 + 0.1 * i) * np.sin(2 * np.pi * (200 + 150 * i) * t)
        wav.write_wav(wp, (y + 0.01 * rng.randn(N)).astype(np.float32),
                      22050)
        Image.fromarray(rng.randint(0, 256, (48, 40, 3), np.uint8)).save(pp)
        reqs.append({'audio_path': wp, 'text': TEXTS[i], 'image_path': pp})
    return {'dirs': dirs, 'written': written, 'reqs': reqs,
            'port32': port32, 'jax32': jax32, 'port16': port16,
            'jax16': jax16}


def test_first_load_converts_and_caches(served):
    """The port's engine writes each .mecp beside its artifact (and the
    scaler's .npz), the files the JAX engine's load and convert_all
    write: flax's bytes."""
    assert served['written'] == sorted(
        f for f in CONVERTED if f != 'text_model_tokenizer.json')
    for name in served['written']:
        if name.endswith('.mecp'):
            with open(os.path.join(served['dirs']['port'], name), 'rb') as g, \
                    open(os.path.join(served['dirs']['jax'], name),
                         'rb') as w:
                if name in ('image_model.mecp', 'bert_model/bert_model.mecp'):
                    # the JAX bf16 engine has added its int8 scales since
                    got, want = store.load_params(g.name), \
                        store.load_params(w.name)
                    assert_same_tree(got['variables'], want['variables'])
                else:
                    assert g.read() == w.read(), name
    eng = served['port32']
    assert eng._all_live and eng._fusion_kind == 'rf'
    assert eng._image_arch == 'mobilenet_v2' and eng.lstm is not None


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_served_directory_matches_jax(served, dtype):
    port, jax = ((served['port32'], served['jax32']) if dtype == 'float32'
                 else (served['port16'], served['jax16']))
    if dtype == 'bfloat16':
        assert port._image_scales_cached and port._bert_scales_cached
    got = port.predict_multimodal_batch(served['reqs'])
    ref = jax.predict_multimodal_batch(served['reqs'])
    atol = 1e-4 if dtype == 'float32' else 0.05
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {'speech', 'text', 'image', 'fusion'}
        assert g['fusion']['method'] == 'random_forest'
        for mod in ('speech', 'text', 'image'):
            assert '_fallback' not in g[mod] and '_fallback' not in r[mod]
            np.testing.assert_allclose(g[mod]['all_probabilities'],
                                       r[mod]['all_probabilities'],
                                       rtol=0, atol=atol, err_msg=mod)
            if dtype == 'float32' or r[mod]['confidence'] > 0.6:
                assert g[mod]['emotion'] == r[mod]['emotion'], mod
    want = jax.predict_texts_lstm(TEXTS)
    lstm = port.predict_texts_lstm(TEXTS)
    np.testing.assert_allclose([g['all_probabilities'] for g in lstm],
                               [w['all_probabilities'] for w in want],
                               rtol=0,
                               atol=1e-5 if dtype == 'float32' else 0.05)


def test_second_load_calls_no_converter(served, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError('a converter ran on a cached directory')

    for mod, names in ((keras_h5, ('convert_speech_h5', 'load_sklearn_scaler',
                                   'convert_lstm_text_h5')),
                       (torch_pt, ('convert_image_pt', 'convert_fusion_pt',
                                   'fusion_config_from_pt')),
                       (hf_bert, ('convert_bert_dir',)),
                       (sklearn_rf, ('convert_fusion_rf',))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    eng = _port_engine(served['dirs']['port'], 'float32')
    assert eng._all_live and eng.lstm is not None
    got = eng.predict_multimodal_batch(served['reqs'][:2])
    want = served['port32'].predict_multimodal_batch(served['reqs'][:2])
    for g, w in zip(got, want):
        for mod in g:
            assert g[mod]['all_probabilities'] == w[mod]['all_probabilities']


# ----------------------------------------------------------------------
# missing readers, the pretrained BERT, C11
# ----------------------------------------------------------------------

@pytest.mark.parametrize('fn,name,package', [
    (keras_h5.convert_speech_h5, 'speech_model.h5', 'h5py'),
    (keras_h5.convert_lstm_text_h5, 'text_model.h5', 'h5py'),
    (keras_h5.load_sklearn_scaler, 'speech_scaler.pkl', 'joblib'),
    (sklearn_rf.convert_fusion_rf, 'fusion_rf.pkl', 'joblib'),
    (hf_bert.convert_bert_dir, 'bert_model', 'safetensors')])
def test_missing_reader_raises_naming_it(ref_dir, monkeypatch, fn, name,
                                         package):
    """As on the card's machine (no h5py, sklearn or joblib): the
    conversion raises an ImportError naming the package and the file."""
    monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(ImportError, match=f'needs the {package} package'):
        fn(os.path.join(ref_dir, name))


def test_pretrained_dir_converts_hf_weights(ref_dir):
    """init_from_pretrained on an HF directory without bert_model.mecp:
    the encoder is the converted one, the classifier keeps its init."""
    from mec_tpu_torch.convert.to_jax import to_jax
    bert_dir = os.path.join(ref_dir, 'bert_model')
    kw = hf_bert.model_kwargs_from_config(hf_bert.read_config(bert_dir))
    torch.manual_seed(0)
    model = BertForSequenceClassification(**kw)
    fresh = to_jax(model)['params']['classifier']
    train_text_bert.init_from_pretrained(model, bert_dir, log=lambda m: None)
    got = to_jax(model)['params']
    want = jhf_bert.convert_bert_dir(bert_dir)['params']
    for k in want:
        assert_same_tree(got[k], fresh if k == 'classifier' else want[k], k)
    assert not os.path.exists(os.path.join(bert_dir, 'bert_model.mecp'))


def test_dense_hf_checkpoint_into_moe_raises(ref_dir):
    """C11: the JAX trainer copies a dense checkpoint over an --experts
    model's MoE layers and fails at its first step; the port raises up
    front, whether the encoder comes from a .mecp or is converted."""
    bert_dir = os.path.join(ref_dir, 'bert_model')
    kw = hf_bert.model_kwargs_from_config(hf_bert.read_config(bert_dir))
    model = BertForSequenceClassification(**kw, num_experts=2)
    with pytest.raises(ValueError, match='a dense layer'):
        train_text_bert.init_from_pretrained(model, bert_dir)
