"""The port's Bi-LSTM text model against the JAX package.

* models.bilstm.BiLSTMTextModel on the JAX model's parameters
  (convert/from_jax.lstm_state_from_jax): fp32 probabilities and
  penultimate within 1e-5 (measured 1.5e-8: summation order only); bf16
  with the same decisions and probabilities within 0.02, the text band of
  tests/test_torch_text.py (measured 4e-5: both sides round the
  embeddings, the recurrence's matmuls and the Dense layers to bf16, but
  torch's LSTM keeps its cell state and gates in fp32 where the Flax
  scan keeps them in bf16);
* the converters: to_jax inverts from_jax bit for bit, the Keras bias is
  bias_ih with bias_hh zero and frozen, and to_jax writes their sum;
* the engine: a directory the JAX trainer wrote (text_model.mecp and
  text_model_tokenizer.json) served by both engines, predict_texts_lstm
  within 1e-5 in fp32 and with equal decisions in bf16 (band 0.02);
* KerasTokenizer: the copy equals the original on fitting, encoding,
  the JSON round trip and a pickled Keras-like tokenizer.
"""

import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.config import Config as JaxConfig
from mec_tpu.models.bilstm import BiLSTMTextModel as JaxLSTM
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu.text.keras_tokenizer import KerasTokenizer as JaxTokenizer
from mec_tpu.training import train_text_lstm as jax_trainer
from mec_tpu_torch.convert.from_jax import lstm_state_from_jax
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.models.bilstm import BiLSTMTextModel
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.text.keras_tokenizer import KerasTokenizer

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples'))
import end_to_end  # noqa: E402


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


KW = dict(vocab_size=60, embed_dim=16, lstm_units=(12, 8),
          dense_units=(16, 8))
BAND = 0.02
TEXTS = ['what a wonderful day i feel great', 'terrible news so down',
         'this makes me furious!', 'i am scared, anxious...',
         'totally unseen words here', '']


@pytest.fixture(scope='module')
def tree():
    ids = jnp.zeros((1, 10), jnp.int32)
    return jax.tree.map(np.asarray,
                        JaxLSTM(**KW).init(jax.random.PRNGKey(3), ids))


def _ids(seed=0):
    ids = np.random.RandomState(seed).randint(0, 60, (5, 20)).astype(np.int32)
    ids[1, 9:] = 0
    ids[3, 2:] = 0
    return ids


@pytest.mark.parametrize('dtype,jdtype', [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_bilstm_forward_matches_jax(tree, dtype, jdtype):
    ids = _ids()
    want_p, want_pen = JaxLSTM(**KW, dtype=jdtype).apply(tree, ids)
    model = BiLSTMTextModel(**KW, dtype=dtype)
    model.load_state_dict(lstm_state_from_jax(tree))
    model.eval()
    with torch.no_grad():
        p, pen = model(torch.from_numpy(ids))
    assert p.dtype == pen.dtype == torch.float32
    if dtype == torch.float32:
        np.testing.assert_allclose(p.numpy(), np.asarray(want_p), atol=1e-5)
        np.testing.assert_allclose(pen.numpy(), np.asarray(want_pen),
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(p.numpy(), np.asarray(want_p), atol=BAND)
        np.testing.assert_array_equal(p.numpy().argmax(-1),
                                      np.asarray(want_p).argmax(-1))


def test_lstm_converters_round_trip(tree):
    model = BiLSTMTextModel(**KW)
    model.load_state_dict(lstm_state_from_jax(tree))
    for name in ('bias_hh_l0', 'bias_hh_l0_reverse'):
        b = getattr(model.bilstm_1, name)
        assert not b.requires_grad and not b.any()
    back = to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    with torch.no_grad():
        model.bilstm_2.bias_hh_l0.fill_(0.5)
    np.testing.assert_array_equal(
        to_jax(model)['params']['bilstm_2']['forward']['bias'],
        tree['params']['bilstm_2']['forward']['bias'] + np.float32(0.5))


def test_keras_tokenizer_copy_matches_original(tmp_path):
    texts = list(end_to_end.make_text_corpus(per_class=5)[0]) + [
        'Hello, World! hello again; HELLO?', 'tabs\tand\nnewlines']
    mine, ref = KerasTokenizer(num_words=20), JaxTokenizer(num_words=20)
    mine.fit_on_texts(texts)
    ref.fit_on_texts(texts)
    assert mine.word_index == ref.word_index
    assert mine.word_counts == ref.word_counts
    np.testing.assert_array_equal(mine.encode_batch(TEXTS, 7),
                                  ref.encode_batch(TEXTS, 7))
    assert mine.texts_to_sequences(TEXTS) == ref.texts_to_sequences(TEXTS)
    mine.to_json_file(str(tmp_path / 'm.json'))
    ref.to_json_file(str(tmp_path / 'r.json'))
    assert (tmp_path / 'm.json').read_bytes() == \
        (tmp_path / 'r.json').read_bytes()
    np.testing.assert_array_equal(
        KerasTokenizer.load(str(tmp_path / 'r.json')).encode_batch(TEXTS, 9),
        ref.encode_batch(TEXTS, 9))
    keras_like = types.SimpleNamespace(
        num_words=None, oov_token='<OOV>', word_index=dict(ref.word_index),
        filters='!,', lower=False, split=' ')
    with open(tmp_path / 't.pkl', 'wb') as f:
        pickle.dump(keras_like, f)
    a = KerasTokenizer.load(str(tmp_path / 't.pkl'))
    b = JaxTokenizer.load(str(tmp_path / 't.pkl'))
    assert vars(a) == vars(b)


@pytest.fixture(scope='module')
def jax_trained(tmp_path_factory):
    """A models directory the JAX trainer wrote: the Bi-LSTM and its
    tokenizer, 1 epoch on the end-to-end text corpus."""
    d = str(tmp_path_factory.mktemp('jax_lstm'))
    texts, labels = end_to_end.make_text_corpus(per_class=6)
    jax_trainer.train(csv_path=None, texts=texts, labels=labels, epochs=1,
                      batch_size=16, max_length=16, vocab_size=200,
                      models_dir=d, verbose=False)
    assert sorted(os.listdir(d)) == ['text_model.mecp',
                                     'text_model_tokenizer.json']
    return d


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_jax_trained_directory_serves_lstm_in_port(jax_trained, dtype):
    old = JaxConfig.COMPUTE_DTYPE
    JaxConfig.COMPUTE_DTYPE = dtype
    try:
        ref = JaxEngine(models_dir=jax_trained, mesh=None)
        want = ref.predict_texts_lstm(TEXTS)
    finally:
        JaxConfig.COMPUTE_DTYPE = old
    eng = EmotionEngine.from_models_dir(jax_trained, compute_dtype=dtype,
                                        device='cpu')
    assert eng.lstm is not None and eng.bert is None and eng.speech is None
    got = eng.predict_texts_lstm(TEXTS)
    assert all('_fallback' not in g for g in got)
    p = np.array([g['all_probabilities'] for g in got])
    q = np.array([w['all_probabilities'] for w in want])
    if dtype == 'float32':
        np.testing.assert_allclose(p, q, atol=1e-5)
        assert [g['emotion'] for g in got] == [w['emotion'] for w in want]
    else:
        np.testing.assert_allclose(p, q, atol=BAND)
        top2 = np.sort(q, axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > BAND
        np.testing.assert_array_equal(p.argmax(1)[sure], q.argmax(1)[sure])


def test_lstm_needs_its_tokenizer(jax_trained, tmp_path):
    """Without text_model_tokenizer.json (or .pkl) the Bi-LSTM is not
    served: the keyword map answers, as in JAX."""
    d = tmp_path / 'no_tok'
    d.mkdir()
    (d / 'text_model.mecp').write_bytes(
        open(os.path.join(jax_trained, 'text_model.mecp'), 'rb').read())
    eng = EmotionEngine.from_models_dir(str(d), device='cpu')
    assert eng.lstm is None
    assert eng.predict_texts_lstm(['i am so happy'])[0]['_fallback']


def test_lstm_h5_without_its_mecp_names_the_converters(jax_trained,
                                                       tmp_path):
    """A reference-format text_model.h5 beside its tokenizer, with no
    .mecp, goes to the Keras converter (convert/keras_h5.py); bytes that
    are no HDF5 file raise there (h5py's OSError; the JAX engine would
    log it and serve the keyword map, C5) and no cache is written."""
    (tmp_path / 'text_model.h5').write_bytes(b'not read')
    (tmp_path / 'text_model_tokenizer.json').write_bytes(
        open(os.path.join(jax_trained, 'text_model_tokenizer.json'),
             'rb').read())
    with pytest.raises(OSError, match='file signature not found'):
        EmotionEngine.from_models_dir(str(tmp_path), device='cpu')
    assert not (tmp_path / 'text_model.mecp').exists()
