"""The port's six trainers write the JAX trainers' models directory.

Each port trainer runs on tiny data with device='cpu' into one models
directory. Held against the JAX package:

* the files and meta keys are the JAX trainers' (train_speech.py:130-137,
  train_text_lstm.py:104-110, train_text_bert.py:254-281,
  train_image.py:206-212, train_fusion.py:246-252,
  train_fusion_rf.py:83-92); for the random forest the JAX trainer itself
  runs on the same data and both directories are compared file by file;
* every Flax tree has the structure, shapes and float32 dtype of the JAX
  model's own init;
* the JAX EmotionEngine(models_dir=...) loads the port-written directory,
  and its fp32 probabilities equal the port engine's within 1e-4 (the
  port's parity contract) for speech, the Bi-LSTM, BERT, the image model
  and the attention fusion;
* the CLI: python -m mec_tpu_torch lists the six train commands, names
  the queue item of each unported one, and each trainer's --help lists
  the JAX trainer's flags and --device.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert import store as jstore
from mec_tpu.models.bert import BertForSequenceClassification as JaxBert
from mec_tpu.models.bilstm import BiLSTMTextModel as JaxLSTM
from mec_tpu.models.fusion import MultiModalFusionModel as JaxFusion
from mec_tpu.models.mobilenet import MobileNetV2EmotionModel as JaxMobile
from mec_tpu.models.speech_dnn import SpeechDNN as JaxSpeech
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu.training import train_fusion_rf as jax_rf
from mec_tpu_torch.__main__ import main as cli_main
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.training import (corpora, train_fusion, train_fusion_rf,
                                    train_image, train_speech,
                                    train_text_bert, train_text_lstm)


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tier-1 run has six workers on the CPU: torch's default of one
    thread a core in each of them makes these small-op workloads spin on
    each other, so this file keeps torch at two threads and restores
    the count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
TEXTS = ['what a wonderful day i feel great', 'terrible news i feel so down',
         'this makes me furious and mad', 'the meeting is at three']
META = {'speech_model.mecp': {'val_acc'}, 'text_model.mecp': {'val_acc'},
        'bert_model/bert_model.mecp': {'val_acc'},
        'image_model.mecp': {'val_acc', 'arch', 'img_size'},
        'fusion_model.mecp': {'config', 'val_acc'},
        'fusion_rf.mecp': {'kind', 'depth', 'n_features', 'n_classes',
                           'classes', 'val_acc'}}


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('port_trained'))
    kw = dict(models_dir=d, verbose=False)
    rng = np.random.RandomState(0)
    y = (np.arange(42) % 7).astype(np.int32)
    X = (rng.randn(42, 56) + y[:, None] * 0.5).astype(np.float32)
    train_speech.train(X=X, y=y, epochs=2, batch_size=16, device='cpu', **kw)
    texts, labels = corpora.make_text_corpus(per_class=5)
    train_text_lstm.train(csv_path=None, texts=texts, labels=labels,
                          epochs=1, batch_size=16, max_length=12,
                          vocab_size=300, device='cpu', **kw)
    tok = corpora.make_bert_tokenizer(texts)
    train_text_bert.train(csv_path=None, texts=texts, labels=labels,
                          tokenizer=tok, epochs=1, batch_size=16,
                          max_length=16,
                          model_kwargs=dict(BERT, vocab_size=len(tok.vocab)),
                          models_dir=os.path.join(d, 'bert_model'),
                          verbose=False, device='cpu')
    imgs, img_labels = corpora.make_image_corpus(img_size=32, per_class=2)
    train_image.train(data_root=None, imgs=imgs, labels=img_labels,
                      img_size=32, epochs=2, phase1_epochs=1, batch_size=8,
                      arch='mobilenet_v2', device='cpu', **kw)
    dataset = train_fusion.generate_synthetic_data(
        70, dims={'speech': 64, 'text': 32, 'image': 512})
    train_fusion.train(dataset=dataset, epochs=1, batch_size=32,
                       device='cpu', **kw)
    train_fusion_rf.train(num_samples=140, n_estimators=4, max_depth=4, **kw)
    return d, tok


def test_trainers_write_the_jax_trainers_files(trained):
    d, tok = trained
    names = sorted(os.path.relpath(os.path.join(r, f), d)
                   for r, _d, fs in os.walk(d) for f in fs)
    assert names == ['bert_model/bert_model.mecp', 'bert_model/config.json',
                     'bert_model/vocab.txt', 'fusion_model.mecp',
                     'fusion_rf.mecp', 'fusion_rf.pkl', 'image_model.mecp',
                     'speech_model.mecp', 'speech_scaler.npz',
                     'text_model.mecp', 'text_model_tokenizer.json']
    for f, keys in META.items():
        assert set(jstore.load_params(os.path.join(d, f))['meta']) == keys, f
    image = jstore.load_params(os.path.join(d, 'image_model.mecp'))['meta']
    assert image['arch'] == 'mobilenet_v2' and image['img_size'] == 32
    cfg = jstore.load_params(os.path.join(d, 'fusion_model.mecp'))['meta']
    assert cfg['config'] == {'speech_dim': 64, 'text_dim': 32,
                             'image_dim': 512, 'num_classes': 7,
                             'hidden_dim': 256}
    with np.load(os.path.join(d, 'speech_scaler.npz')) as z:
        assert sorted(z.files) == ['mean', 'scale']
        assert z['mean'].dtype == np.float32 and z['mean'].shape == (56,)
    with open(os.path.join(d, 'bert_model', 'config.json')) as f:
        assert json.load(f) == {
            'vocab_size': len(tok.vocab), 'hidden_size': 32,
            'num_hidden_layers': 2,
            'num_attention_heads': 2, 'intermediate_size': 64,
            'max_position_embeddings': 512, 'type_vocab_size': 2,
            'num_labels': 7}


def test_trees_have_the_jax_models_layout(trained):
    d, tok = trained

    def init(model, *args):
        return jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

    ids = jnp.zeros((1, 8), jnp.int32)
    z = lambda n: jnp.zeros((1, n))  # noqa: E731
    want = {
        'speech_model.mecp': init(JaxSpeech(), z(56)),
        'text_model.mecp': init(JaxLSTM(vocab_size=300), ids),
        'bert_model/bert_model.mecp': init(
            JaxBert(**BERT, vocab_size=len(tok.vocab)), ids, ids),
        'image_model.mecp': init(JaxMobile(), jnp.zeros((1, 32, 32, 3))),
        'fusion_model.mecp': init(JaxFusion(text_dim=32), z(64), z(32),
                                  z(512), z(7), z(7), z(7)),
    }
    for f, tree in want.items():
        got = jstore.load_params(os.path.join(d, f))['variables']
        assert jax.tree.structure(got) == jax.tree.structure(tree), f
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32, f


def test_fusion_rf_matches_the_jax_trainer(trained, tmp_path):
    d, _tok = trained
    jax_rf.train(num_samples=140, n_estimators=4, max_depth=4,
                 models_dir=str(tmp_path), verbose=False)
    mine = jstore.load_params(os.path.join(d, 'fusion_rf.mecp'))
    theirs = jstore.load_params(str(tmp_path / 'fusion_rf.mecp'))
    assert mine['meta'] == theirs['meta']
    for k, v in theirs['variables']['forest'].items():
        np.testing.assert_array_equal(mine['variables']['forest'][k], v)
    assert sorted(os.listdir(tmp_path)) == ['fusion_rf.mecp', 'fusion_rf.pkl']


@pytest.fixture(scope='module')
def engines(trained):
    d, _tok = trained
    old = JaxConfig.COMPUTE_DTYPE
    JaxConfig.COMPUTE_DTYPE = 'float32'
    try:
        ref = JaxEngine(models_dir=d, mesh=None)
    finally:
        JaxConfig.COMPUTE_DTYPE = old
    port = EmotionEngine.from_models_dir(d, compute_dtype='float32',
                                         device='cpu')
    return ref, port


def _probs(results):
    assert all('_fallback' not in r for r in results)
    return np.array([r['all_probabilities'] for r in results])


def test_jax_engine_serves_the_port_written_directory(engines):
    ref, port = engines
    assert ref.speech and ref.bert and ref.image and ref.fusion and ref.lstm
    rng = np.random.RandomState(5)
    t = np.arange(66150) / 22050.0
    waves = np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.01 * rng.randn(66150)
                      for f in (220, 330, 440)]).astype(np.float32)
    imgs = rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    pairs = [
        (port.predict_speech_waves(waves), ref.predict_speech_waves(waves)),
        (port.predict_texts_lstm(TEXTS), ref.predict_texts_lstm(TEXTS)),
        (port.predict_texts(TEXTS), ref.predict_texts(TEXTS)),
        (port.predict_images(imgs), ref.predict_images(imgs)),
    ]
    feats = [rng.randn(n).astype(np.float32) for n in (64, 32, 512)]
    preds = [rng.dirichlet(np.ones(7)).astype(np.float32) for _ in range(3)]
    pairs.append(([port.fuse_attention(*feats, *preds)],
                  [ref.fuse_attention(*feats, *preds)]))
    for got, want in pairs:
        np.testing.assert_allclose(_probs(got), _probs(want), rtol=0,
                                   atol=1e-4)


def test_cli_lists_the_train_commands_and_their_flags(capsys):
    out = subprocess.run([sys.executable, '-m', 'mec_tpu_torch', '--help'],
                         cwd=_REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    for cmd in ('train-speech', 'train-text-bert', 'train-text-lstm',
                'train-image', 'train-fusion', 'train-fusion-rf'):
        assert cmd in out.stdout
    for cmd in ('serve', 'convert', 'download', 'organize'):
        line = next(ln for ln in out.stdout.splitlines()
                    if ln.split()[:1] == [cmd])
        assert 'not ported' not in line, line
    with pytest.raises(SystemExit) as done:
        cli_main(['organize', '--help'])
    assert done.value.code == 0
    assert 'speech,images,text,all' in capsys.readouterr().out
    flags = {
        'train-speech': ('--data-root', '--pattern', '--label-from',
                         '--no-augment', '--mesh-data', '--checkpoint',
                         '--resume'),
        'train-text-lstm': ('--csv', '--vocab-size', '--max-length',
                            '--mesh-data'),
        'train-text-bert': ('--pretrained-dir', '--mesh-data',
                            '--mesh-model', '--mesh-pipe', '--microbatches',
                            '--grad-accum', '--remat', '--experts',
                            '--seq-parallel', '--bf16', '--no-seq-bucket'),
        'train-image': ('--img-size', '--phase1-epochs', '--bf16',
                        '--grad-accum', '--remat', '--arch', '--mesh-data'),
        'train-fusion': ('--learning-rate', '--num-samples', '--manifest',
                         '--mesh-data'),
        'train-fusion-rf': ('--n-estimators', '--max-depth', '--manifest'),
    }
    for cmd, want in flags.items():
        with pytest.raises(SystemExit) as e:
            cli_main([cmd, '--help'])
        assert e.value.code == 0
        text = capsys.readouterr().out
        for flag in want + ('--models-dir', '--device'):
            assert flag in text, (cmd, flag)
        # the mesh axes are ported: the help names no unported item
        assert 'not ported' not in text and 'item 12' not in text, cmd
