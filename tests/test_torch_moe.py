"""The port's mixture-of-experts BERT (models/moe.py, the MoE layers of
models/bert.py, its trainer and its serving) against the JAX package.

Both packages get the same parameters (the Flax module's init, or the
port's synthetic tree, carried into the port by convert/from_jax).
Tolerances, each with its reason:

* MoEFFN output and aux loss, fp32: 1e-6 (the dispatch and combine are
  exact selections in both forms; only the router's and the expert
  GEMMs' summation orders differ; measured <= 1.2e-7);
* a 2-layer MoE BERT, fp32: logits, [CLS] and each layer's aux within
  1e-5;
* the ported tests/test_moe.py properties: as there (dense FFN 1e-5,
  dropped tokens exactly 0, mask and batch invariance 1e-5);
* a JAX-trained --experts 2 directory served by both engines on the
  CPU: fp32 probabilities within 1e-4 (the parity contract); bf16 (int8
  attention, bf16 experts, the JAX engine's cached scales) within 0.02,
  tests/test_torch_text.py's dense BERT band (a near-tie router input
  one bf16 step apart could pick another expert; none does here);
* the port's trainer with --experts 2 from the JAX trainer's init,
  dropout off on both sides: training loss within 1e-4 relative, val_acc
  within one validation row;
* remat: gradients and the aux loss bit-equal to no remat.
"""

import json
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.config import Config as JaxConfig
from mec_tpu.convert.hf_bert import model_kwargs_from_config
from mec_tpu.models.bert import BertForSequenceClassification as JaxBert
from mec_tpu.models.moe import MoEFFN as JaxMoE
from mec_tpu.ops import quant as jquant
from mec_tpu.serving.engine import EmotionEngine as JaxEngine
from mec_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
from mec_tpu.training import common as jcommon
from mec_tpu.training import train_text_bert as jax_bert_trainer
from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.from_jax import state_dict_from_jax, state_from_jax
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.models.moe import MoEFFN
from mec_tpu_torch.ops import quant
from mec_tpu_torch.serving import engine as engine_module
from mec_tpu_torch.serving import synthetic_artifacts as sa
from mec_tpu_torch.serving.engine import EmotionEngine, get_engine
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer
from mec_tpu_torch.training import common, train_text_bert


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """Six tier-1 workers share the CPU: two torch threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


H, FI = 16, 32
KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
          intermediate_size=64, max_position=64)
VOCAB = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', 'happy', 'sad', 'day', 'angry',
         'storm', 'calm', 'sea', 'news']
TEXTS = ['happy happy day', 'sad sad news', 'angry storm', 'calm sea day',
         'happy news', 'sad storm day sea', 'calm', 'angry angry news day']


def _moe_pair(E, cf, seed=0, approx=False, shape=(3, 10, H)):
    """The Flax MoEFFN's init (perturbed off its zero biases) and the
    port's module carrying it."""
    rng = np.random.RandomState(seed)
    jm = JaxMoE(H, FI, E, cf, gelu_approximate=approx)
    v = jm.init(jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))
    v = jax.tree.map(lambda a: (np.asarray(a) + 0.1 * rng.randn(*a.shape))
                     .astype(np.float32), v)
    tm = MoEFFN(H, FI, E, cf, gelu_approximate=approx)
    tm.load_state_dict(state_from_jax(v))
    return jm, v, tm.eval()


def _jax_moe(jm, v, x, mask=None):
    y, mut = jm.apply(v, jnp.asarray(x),
                      None if mask is None else jnp.asarray(mask),
                      mutable=['losses'])
    return np.asarray(y), float(jax.tree.leaves(mut)[0])


def _port_moe(tm, x, mask=None):
    with torch.no_grad():
        y, aux = tm(torch.from_numpy(x),
                    None if mask is None else torch.from_numpy(mask))
    return y.numpy(), float(aux)


# ----------------------------------------------------------------------
# MoEFFN against the Flax module
# ----------------------------------------------------------------------

@pytest.mark.parametrize('E,cf,approx', [(4, 1.25, False), (2, 0.5, True),
                                         (3, 2.0, False)])
def test_moe_ffn_matches_flax(E, cf, approx):
    jm, v, tm = _moe_pair(E, cf, approx=approx)
    x = np.random.RandomState(1).randn(3, 10, H).astype(np.float32)
    mask = np.ones((3, 10), bool)
    mask[1, 6:] = False
    mask[2, 2:] = False
    for m in (None, mask):
        want, want_aux = _jax_moe(jm, v, x, m)
        got, got_aux = _port_moe(tm, x, m)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert abs(got_aux - want_aux) <= 1e-6


def test_moe_single_expert_matches_dense_ffn():
    """tests/test_moe.py:16: E=1 with ample capacity is the dense FFN."""
    jm, v, tm = _moe_pair(1, 1.0, shape=(2, 5, H))
    x = np.random.RandomState(0).randn(2, 5, H).astype(np.float32)
    p = v['params']
    dense = np.asarray(jax.nn.gelu(x @ p['wi'][0] + p['bi'][0],
                                   approximate=False)) @ p['wo'][0] \
        + p['bo'][0]
    got, _ = _port_moe(tm, x)
    want, _ = _jax_moe(jm, v, x)
    np.testing.assert_allclose(got, dense, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_moe_over_capacity_tokens_drop_to_zero():
    """tests/test_moe.py:33: C = max(1, int(1e-6 * 6 / 1)) = 1, so only
    the first token is processed."""
    jm, v, tm = _moe_pair(1, 1e-6, shape=(1, 6, 4 * 4))
    x = np.ones((1, 6, H), np.float32)
    got, _ = _port_moe(tm, x)
    assert np.abs(got[0, 0]).max() > 0
    np.testing.assert_array_equal(got[0, 1:], 0)
    np.testing.assert_allclose(got, _jax_moe(jm, v, x)[0], atol=1e-6, rtol=0)


def _bert_pair(**kw):
    cfg = dict(KW, num_experts=kw.pop('num_experts', 4), **kw)
    jm = JaxBert(**cfg)
    ids = jnp.ones((1, 8), jnp.int32)
    v = jm.init(jax.random.PRNGKey(0), ids, ids)
    v = jax.tree.map(np.asarray, v)
    pm = BertForSequenceClassification(**cfg)
    pm.load_state_dict(state_dict_from_jax(pm, v))
    return jm, v, pm.eval()


def _port_bert(pm, ids, mask):
    with torch.no_grad():
        logits, cls, aux = pm(torch.from_numpy(ids), torch.from_numpy(mask),
                              return_aux=True)
    return logits.numpy(), cls.numpy(), [float(a) for a in aux]


def test_moe_exact_wrt_attention_mask():
    """tests/test_moe.py:100: with capacity_factor 2 and E=2 no expert
    can overflow at L=8 or L=16, so padding to 16 changes no logit
    (padding tokens never route)."""
    jm, v, pm = _bert_pair(num_experts=2, moe_capacity_factor=2.0)
    rng = np.random.RandomState(3)
    ids8 = rng.randint(1, 64, (2, 8)).astype(np.int32)
    mask8 = np.ones((2, 8), np.int32)
    mask8[:, 6:] = 0
    ids16 = np.zeros((2, 16), np.int32)
    ids16[:, :8] = ids8
    mask16 = np.zeros((2, 16), np.int32)
    mask16[:, :8] = mask8
    got8, _, _ = _port_bert(pm, ids8, mask8)
    got16, _, _ = _port_bert(pm, ids16, mask16)
    np.testing.assert_allclose(got8, got16, atol=1e-5)
    want8, _ = jm.apply(v, ids8, mask8)
    np.testing.assert_allclose(got8, np.asarray(want8), atol=1e-5)


def test_moe_batch_composition_invariance():
    """tests/test_moe.py:134: routing groups are examples, so a row's
    logits do not depend on its batch-mates (at capacity 1.0, where a
    batch-global cumsum would drop tokens)."""
    jm, v, pm = _bert_pair(num_experts=2, moe_capacity_factor=1.0,
                           num_layers=1)
    ids = np.random.RandomState(4).randint(1, 64, (4, 8)).astype(np.int32)
    mask = np.ones((4, 8), np.int32)
    batched, _, _ = _port_bert(pm, ids, mask)
    alone, _, _ = _port_bert(pm, ids[:1], mask[:1])
    np.testing.assert_allclose(batched[:1], alone, atol=1e-5)
    want, _ = jm.apply(v, ids, mask)
    np.testing.assert_allclose(batched, np.asarray(want), atol=1e-5)


def test_moe_bert_fp32_matches_jax():
    jm, v, pm = _bert_pair()
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 64, (3, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    mask[2, 4:] = 0
    (want, wcls), mut = jm.apply(v, ids, mask, mutable=['losses'])
    got, gcls, aux = _port_bert(pm, ids, mask)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gcls, np.asarray(wcls), atol=1e-5, rtol=0)
    want_aux = [float(a) for a in jax.tree.leaves(mut['losses'])]
    np.testing.assert_allclose(aux, want_aux, atol=1e-5, rtol=0)


def test_moe_tree_converts_both_ways_and_quantizes_like_jax():
    """to_jax(from_jax(tree)) is the tree; the synthetic MoE tree has the
    Flax model's keys and shapes; quantize_bert_params leaves `moe`
    alone and equals the JAX function's tree."""
    _jm, v, pm = _bert_pair()
    back = to_jax(pm)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(v)))
    syn = sa.bert_variables(0, **{k: v_ for k, v_ in KW.items()
                                  if k != 'num_heads'}, num_experts=4)
    assert jax.tree.map(np.shape, syn) == jax.tree.map(np.shape, v)
    got, want = quant.quantize_bert_params(syn), \
        jquant.quantize_bert_params(syn)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    assert 'kernel_q' not in str(jax.tree.structure(got['params']['layer_0']
                                                    ['moe']))


def test_moe_remat_counts_aux_once():
    """remat recomputes each layer in the backward pass; the aux losses
    and the gradients equal the run without it, bit for bit."""
    out = []
    for remat in (False, True):
        torch.manual_seed(0)
        m = common.flax_init(BertForSequenceClassification(
            **KW, num_experts=2, remat=remat), 0).train()
        ids = torch.randint(0, 64, (4, 12))
        mask = torch.ones(4, 12, dtype=torch.int32)
        mask[2, 7:] = 0
        logits, _cls, aux = m(ids, mask, return_aux=True)
        (logits.sum() + 0.01 * sum(aux)).backward()
        out.append(([float(a) for a in aux],
                    [p.grad.clone() for p in m.parameters()]))
    assert out[0][0] == out[1][0] and len(out[0][0]) == 2
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ----------------------------------------------------------------------
# the trainer and the engine against the JAX package
# ----------------------------------------------------------------------

TRAIN_KW = dict(vocab_size=16, hidden_size=16, num_layers=2, num_heads=2,
                intermediate_size=32, max_position=128)


def _corpus():
    texts = [TEXTS[i % 8] for i in range(40)]
    labels = [i % 4 for i in range(40)]
    return texts, labels


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """The JAX trainer's --experts 2 run (dropout off) and its directory,
    and its initial parameters."""
    d = tmp_path_factory.mktemp('moe_models')
    init = {}
    fit, call = jcommon.fit, fnn.Dropout.__call__

    def spy(state, *a, **k):
        init['params'] = jax.tree.map(np.asarray, state.params)
        return fit(state, *a, **k)

    jcommon.fit = spy
    fnn.Dropout.__call__ = lambda self, inputs, *a, **k: inputs
    try:
        texts, labels = _corpus()
        _v, hist = jax_bert_trainer.train(
            '', texts=texts, labels=labels, verbose=False, epochs=3,
            batch_size=8, experts=2, learning_rate=5e-3,
            models_dir=str(d / 'bert_model'),
            tokenizer=JaxTokenizer({t: i for i, t in enumerate(VOCAB)}),
            model_kwargs=TRAIN_KW)
    finally:
        jcommon.fit, fnn.Dropout.__call__ = fit, call
    return str(d), init, hist


def test_moe_trainer_follows_jax(trained, tmp_path, monkeypatch):
    models, init, want = trained
    monkeypatch.setattr(torch.nn.Dropout, 'forward', lambda self, x: x)
    monkeypatch.setattr(common, 'flax_init', lambda m, seed: m.load_state_dict(
        state_dict_from_jax(m, init)) and m or m)
    texts, labels = _corpus()
    out = tmp_path / 'bert_model'
    best, got = train_text_bert.train(
        '', texts=texts, labels=labels, verbose=False, epochs=3,
        batch_size=8, experts=2, learning_rate=5e-3, models_dir=str(out),
        tokenizer=WordPieceTokenizer({t: i for i, t in enumerate(VOCAB)}),
        model_kwargs=TRAIN_KW, device='cpu')
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)
    np.testing.assert_allclose(got['val_acc'], want['val_acc'], rtol=0,
                               atol=1 / 6 + 1e-9)
    cfg = json.load(open(out / 'config.json'))
    want_cfg = json.load(open(os.path.join(models, 'bert_model',
                                           'config.json')))
    assert cfg == want_cfg and cfg['num_experts'] == 2
    assert model_kwargs_from_config(cfg)['num_experts'] == 2
    assert 'moe' in best['params']['layer_0']


def test_moe_trainer_refusals(tmp_path):
    texts, labels = _corpus()
    kw = dict(csv_path=None, texts=texts, labels=labels, verbose=False,
              device='cpu', experts=2, model_kwargs=TRAIN_KW,
              tokenizer=WordPieceTokenizer({t: i for i, t in
                                            enumerate(VOCAB)}))
    with pytest.raises(SystemExit, match='--mesh-pipe'):
        train_text_bert.train(**kw, mesh_pipe=2)
    # expert parallelism needs its group (two ranks)
    with pytest.raises(RuntimeError, match='group of 2 ranks'):
        train_text_bert.train(**kw, mesh_model=2)
    # a dense pretrained encoder cannot initialise an MoE model
    dense = common.flax_init(BertForSequenceClassification(**TRAIN_KW), 1)
    store.save_params(str(tmp_path / 'bert_model.mecp'), to_jax(dense))
    moe = BertForSequenceClassification(**TRAIN_KW, num_experts=2)
    with pytest.raises(ValueError, match='dense layer'):
        train_text_bert.init_from_pretrained(moe, str(tmp_path))


def _engines(models, dtype):
    old = JaxConfig.COMPUTE_DTYPE
    JaxConfig.COMPUTE_DTYPE = dtype
    try:
        jax_eng = JaxEngine(models_dir=models, mesh=None)
    finally:
        JaxConfig.COMPUTE_DTYPE = old
    return jax_eng, EmotionEngine.from_models_dir(models, compute_dtype=dtype,
                                                  device='cpu')


def _probs(results):
    return np.array([r['all_probabilities'] for r in results])


def test_moe_directory_serves_like_the_jax_engine(trained, tmp_path):
    """fp32 within 1e-4 at every sequence bucket; bf16 (int8 attention,
    bf16 experts) takes the JAX engine's cached scales and stays within
    the dense text band; and the other way round, the JAX engine takes
    the scales the port calibrated (the same keys)."""
    models, _init, _h = trained
    fresh = str(tmp_path / 'fresh')
    shutil.copytree(models, fresh)
    long_text = ' '.join(TEXTS) * 3       # past 32 tokens: bucket 128
    texts = TEXTS[:5] + [long_text, 'day ' * 20]
    jax32, port32 = _engines(models, 'float32')
    assert port32.bert['model'].num_experts == 2
    lengths = {port32._seq_slice(*port32.bert_tokenizer.encode_batch(
        [t], 128))[0].shape[1] for t in texts}
    assert lengths == {16, 32, 128}
    want = _probs(jax32.predict_texts(texts))
    got = _probs(port32.predict_texts(texts))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    jax16, port16 = _engines(models, 'bfloat16')
    assert port16._bert_quant_mode == 'static' and port16._bert_scales_cached
    cached = store.load_params(os.path.join(
        models, 'bert_model', 'bert_model.mecp'))['meta']['int8_scales']
    assert set(cached[port16._bert_scales_key()]) == {
        f'layer_{i}/{n}' for i in range(2) for n in (
            'attention_self/query', 'attention_self/key',
            'attention_self/value', 'attention_output')}
    want = _probs(jax16.predict_texts(texts))
    got = _probs(port16.predict_texts(texts))
    np.testing.assert_allclose(got, want, atol=0.02, rtol=0)
    port_first = EmotionEngine.from_models_dir(fresh, compute_dtype='bfloat16',
                                               device='cpu')
    assert not port_first._bert_scales_cached
    jax_next, _p = _engines(fresh, 'bfloat16')
    assert jax_next._bert_scales_cached


def test_moe_trimodal_engine_serves_every_bucket(tmp_path, monkeypatch):
    """The port's writer's tiny directory with an MoE BERT (E=4,
    capacity 1.25) through get_engine: the tri-modal step's text part
    equals the text route's at each sequence bucket, in fp32 and
    bf16."""
    d = sa.write_synthetic_artifacts(str(tmp_path / 'm'), tiny=True,
                                     image_arch='mobilenet_v2', image_size=32,
                                     bert_experts=4)
    cfg = json.load(open(os.path.join(d, 'bert_model', 'config.json')))
    assert cfg['num_experts'] == 4 and cfg['moe_capacity_factor'] == 1.25
    rng = np.random.RandomState(0)
    waves = (0.1 * rng.randn(3, 66150)).astype(np.float32)
    imgs = rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    texts = ['i am so happy today', 'sad ' * 20, 'angry ' * 60]
    for dtype in ('float32', 'bfloat16'):
        monkeypatch.setattr(Config, 'COMPUTE_DTYPE', dtype)
        monkeypatch.setattr(engine_module, '_engine', None)
        eng = get_engine(d, device='cpu')
        assert eng._all_live and eng.bert['model'].num_experts == 4
        assert eng.compute_dtype == getattr(torch, dtype)
        for t in texts:
            row = eng._run_trimodal(waves[:1], [t], imgs[:1])[0]
            alone = _probs(eng.predict_texts([t]))[0]
            assert np.isfinite(row).all()
            np.testing.assert_allclose(row[7:14], alone, atol=1e-6, rtol=0)
