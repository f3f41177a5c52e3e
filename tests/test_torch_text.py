"""The port's text branch (tokenizer, BERT, BERT int8) against the JAX package.

Both packages get the same parameters: a tiny BERT tree (2 layers,
hidden 64, 2 heads) made with numpy by
mec_tpu_torch.serving.synthetic_artifacts.bert_variables, applied by the
Flax model and loaded by the port's. Tolerances, each with its reason:

* fp32: logits and the [CLS] state within 1e-4 (the parity contract;
  measured ~2e-6, summation order only);
* bf16, and bf16 int8 with dynamic or static scales: probabilities
  within 0.02, tests/test_quant.py's BERT band (both sides round to
  bf16 at the same points, but oneDNN and XLA accumulate the bf16
  matmuls in other orders and GELU/LayerNorm round at other steps, so a
  few activations land one bf16 step apart and may move an int8 code);
* the sequence-bucket slice and batch invariance: exact (additive
  -inf/f32-min mask; per-row scales).

Also pinned: the copied tokenizer, cleaning and keyword map equal their
originals, the int8 tree functions produce equal trees, and the
synthetic BERT tree has the Flax model's keys and shapes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.models.bert import BertForSequenceClassification as JaxBert
from mec_tpu.ops import quant as jquant
from mec_tpu.serving import synthetic_artifacts as jsyn
from mec_tpu.serving.engine import KEYWORD_MAP as JAX_KEYWORD_MAP
from mec_tpu.text.cleaning import clean_text as jax_clean_text
from mec_tpu.text.wordpiece import WordPieceTokenizer as JaxTokenizer
from mec_tpu_torch.convert.from_jax import bert_state_from_jax
from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.models.qconv import QuantDense
from mec_tpu_torch.ops import quant
from mec_tpu_torch.serving.engine import KEYWORD_MAP
from mec_tpu_torch.serving.synthetic_artifacts import (bert_variables,
                                                       make_vocab)
from mec_tpu_torch.text.cleaning import clean_text
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(vocab_size=200, hidden_size=64, num_layers=2,
              intermediate_size=128, max_position=64)
CFG = dict(WIDTHS, num_heads=2)

CORPUS = [
    'I am SO happy today!!!', 'sad... very sad :(', "Don't be angry, ok?",
    'naïve café résumé', 'Ünïcödé ÀÉÎÕÜ', '中文字符 mixed with 日本',
    'tabs\tand\nnewlines\r here', 'x' * 120 + ' long word', '',
    'http://example.com visit www.site.org now', 'emoji 😀 and ✨ stars',
    'numbers 12345 and 3.14', 'feeling feelings felt feel', '​ zero\x00',
]


@pytest.fixture(scope='module')
def tree():
    return bert_variables(1, **WIDTHS)


@pytest.fixture(scope='module')
def inputs():
    ids = np.random.RandomState(0).randint(0, 200, (3, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 10:] = 0
    mask[2, 5:] = 0
    return ids, mask


def _port(tree, dtype, **kw):
    m = BertForSequenceClassification(**CFG, dtype=dtype, **kw)
    m.load_state_dict(bert_state_from_jax(tree))
    return m.eval()


def _run(model, ids, mask):
    with torch.no_grad():
        logits, cls = model(torch.from_numpy(ids), torch.from_numpy(mask))
    return logits.numpy(), cls.numpy()


def _softmax(x):
    return np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))


# ----------------------------------------------------------------------
# copied host modules
# ----------------------------------------------------------------------

def test_tokenizer_copy_matches_original():
    vocab = make_vocab()
    assert vocab == jsyn.make_vocab()
    got, ref = WordPieceTokenizer(vocab), JaxTokenizer(vocab)
    for text in CORPUS:
        assert got.tokenize(text) == ref.tokenize(text)
    for L in (8, 16, 128):
        for a, b in zip(got.encode_batch(CORPUS, L),
                        ref.encode_batch(CORPUS, L)):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    upper = {'[PAD]': 0, '[UNK]': 1, '[CLS]': 2, '[SEP]': 3, 'Happy': 4}
    assert WordPieceTokenizer(upper, do_lower_case=False).tokenize(
        'Happy happy') == JaxTokenizer(upper, do_lower_case=False).tokenize(
        'Happy happy') == ['Happy', '[UNK]']


def test_tokenizer_code_matches_original():
    def code(path):
        with open(os.path.join(_REPO, path), encoding='utf-8') as f:
            return f.read().split('"""', 2)[2]          # drop the docstring
    for name in ('wordpiece.py', 'cleaning.py'):
        assert code(f'mec_tpu_torch/text/{name}') == \
            code(f'mec_tpu/text/{name}')


def test_cleaning_and_keyword_map_match_original():
    for text in CORPUS:
        assert clean_text(text) == jax_clean_text(text)
    assert KEYWORD_MAP == JAX_KEYWORD_MAP


def test_synthetic_bert_tree_matches_flax_init(tree):
    ids = jnp.zeros((1, 8), jnp.int32)
    ref = JaxBert(**CFG).init(jax.random.PRNGKey(0), ids, ids)
    got = jax.tree_util.tree_map(np.shape, tree)
    want = jax.tree_util.tree_map(np.shape, {'params': ref['params']})
    assert got == want
    assert all(a.dtype == np.float32
               for a in jax.tree_util.tree_leaves(tree))


# ----------------------------------------------------------------------
# BERT
# ----------------------------------------------------------------------

def test_bert_fp32_matches_jax(tree, inputs):
    ids, mask = inputs
    want, wcls = JaxBert(**CFG).apply(tree, ids, mask)
    got, gcls = _run(_port(tree, torch.float32), ids, mask)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(gcls, np.asarray(wcls), atol=1e-4)


def test_bert_bf16_matches_jax(tree, inputs):
    ids, mask = inputs
    want, _ = JaxBert(**CFG, dtype=jnp.bfloat16,
                      gelu_approximate=True).apply(tree, ids, mask)
    got, _ = _run(_port(tree, torch.bfloat16, gelu_approximate=True),
                  ids, mask)
    np.testing.assert_allclose(_softmax(got), _softmax(want), atol=0.02)


def test_quantize_bert_params_tree_equal(tree):
    got, ref = quant.quantize_bert_params(tree), jquant.quantize_bert_params(
        tree)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_r]
    for (_p, a), (_q, b) in zip(flat_g, flat_r):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert sum(1 for p, _ in flat_g if p[-1].key == 'kernel_q') == 12
    with pytest.raises(ValueError, match='no encoder layers'):
        quant.quantize_bert_params({'params': {'pooler': {}}})
    scales = {f'layer_{i}/{n}': 0.01 * (i + 1)
              for i in range(2) for n in ('attention_self/query',
                                          'attention_self/key',
                                          'attention_self/value',
                                          'attention_output', 'intermediate',
                                          'output')}
    a = quant.insert_static_scales(got, scales)
    b = jquant.insert_static_scales(ref, scales)
    assert quant.extract_static_scales(a) == jquant.extract_static_scales(b) \
        == pytest.approx(scales)
    with pytest.raises(ValueError, match='missing'):
        quant.insert_static_scales(got, dict(list(scales.items())[1:]))


@pytest.mark.parametrize('mode', ['dynamic', 'static'])
def test_bert_int8_matches_jax(tree, inputs, mode):
    ids, mask = inputs
    jq = jquant.quantize_bert_params(tree)
    tq = quant.quantize_bert_params(tree)
    kw = dict(gelu_approximate=True, quant=True)
    if mode == 'static':
        jq = jquant.calibrate_static_scales(
            JaxBert(**CFG, dtype=jnp.bfloat16, **kw), jq, (ids, mask))
        tq = quant.calibrate_static_scales(
            _port(tq, torch.bfloat16, **kw), tq,
            (torch.from_numpy(ids), torch.from_numpy(mask)))
        got_s = quant.extract_static_scales(tq)
        ref_s = jquant.extract_static_scales(jq)
        assert set(got_s) == set(ref_s)
        for k in ref_s:   # bf16 activations may round a step apart
            assert got_s[k] == pytest.approx(ref_s[k], rel=2e-2)
        tq = quant.insert_static_scales(tq, ref_s)      # same scales
    want, _ = JaxBert(**CFG, dtype=jnp.bfloat16, quant_mode=mode,
                      **kw).apply(jq, ids, mask)
    model = BertForSequenceClassification(**CFG, dtype=torch.bfloat16,
                                          quant_mode=mode, **kw)
    model.load_state_dict(bert_state_from_jax(tq))
    got, _ = _run(model, ids, mask)
    np.testing.assert_allclose(_softmax(got), _softmax(want), atol=0.02)


def test_bert_seq_bucket_slice_exact(tree, inputs):
    """Dropping padded keys changes no logit: their bias is the f32
    minimum (-inf in bf16), so their attention weight is exactly 0.0,
    and int8 per-token scales keep every real row's quantization. bf16
    and int8 are bit-exact; in fp32 the CPU matmul blocks its sums by
    the sequence length, so the JAX test's 1e-6
    (tests/test_inference.py::test_bert_seq_bucket_exact) applies."""
    ids, mask = inputs
    ids, mask = ids.copy(), mask.copy()
    mask[0, 12:] = 0
    for dtype, kw, atol in ((torch.float32, {}, 1e-6),
                            (torch.bfloat16, dict(gelu_approximate=True), 0),
                            (torch.bfloat16, dict(gelu_approximate=True,
                                                  quant=True), 0)):
        t = quant.quantize_bert_params(tree) if kw.get('quant') else tree
        model = _port(t, dtype, **kw)
        (logits, cls), (s_logits, s_cls) = (
            _run(model, ids, mask), _run(model, ids[:, :12], mask[:, :12]))
        np.testing.assert_allclose(_softmax(s_logits), _softmax(logits),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(s_cls, cls, rtol=0, atol=atol)


def test_bert_int8_batch_invariant(tree, inputs):
    ids, mask = inputs
    model = _port(quant.quantize_bert_params(tree), torch.bfloat16,
                  gelu_approximate=True, quant=True)
    batched = _run(model, ids, mask)
    for i in range(3):
        single = _run(model, ids[i:i + 1], mask[i:i + 1])
        for a, b in zip(single, batched):
            np.testing.assert_array_equal(a[0], b[i])


def test_quant_dense_matches_jax_module():
    from mec_tpu.models.qconv import QuantDense as JaxQuantDense
    rng = np.random.RandomState(5)
    node = jquant.quantize_conv({'kernel': rng.randn(24, 16).astype(
        np.float32) * 0.1, 'bias': rng.randn(16).astype(np.float32) * 0.1})
    x = (rng.randn(3, 5, 24) * 2).astype(np.float32)
    want = JaxQuantDense(16).apply({'params': node}, x)
    layer = QuantDense(24, 16, dtype=torch.float32)
    layer.load_state_dict({k.split('.', 1)[1]: v for k, v in
                           bert_state_from_jax({'params': {'d': node}}).items()})
    got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert float(layer.act_amax) == pytest.approx(
        float(np.abs(x).max()), rel=1e-6)
    with pytest.raises(ValueError, match='mode'):
        QuantDense(4, 4, mode='per-tensor')

