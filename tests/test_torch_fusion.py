"""The port's attention fusion network against the JAX package.

Both packages get the same parameters, a fusion tree made with numpy by
mec_tpu_torch.serving.synthetic_artifacts.fusion_variables (text_dim 64
here, as the tiny BERT's [CLS]; 768 at full width), and the same
numpy-seeded features and per-modality probabilities. Tolerances, each
with its reason:

* fp32: probabilities, attention and decision weights within 1e-4 (the
  parity contract; summation order only);
* bf16: within 0.02 (the BERT and image bands of tests/test_quant.py):
  both sides round at the same points, including the fp32 MHA
  in-projection that Flax's raw parameters give, but accumulate the
  bf16 matmuls in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.models.fusion import MultiModalFusionModel as JaxFusion
from mec_tpu_torch.convert.from_jax import fusion_state_from_jax
from mec_tpu_torch.models.fusion import MultiModalFusionModel
from mec_tpu_torch.serving.synthetic_artifacts import fusion_variables

CFG = dict(speech_dim=64, text_dim=64, image_dim=512, hidden_dim=256,
           num_classes=7)


@pytest.fixture(scope='module')
def tree():
    return fusion_variables(4, speech_dim=64, text_dim=64, image_dim=512)


def _inputs(B=5, seed=0):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, d).astype(np.float32) for d in (64, 64, 512)]
    probs = [rng.dirichlet(np.ones(7) * 0.5, B).astype(np.float32)
             for _ in range(3)]
    return feats + probs


def _packed(logits, aw, dw):
    return np.concatenate([np.asarray(jax.nn.softmax(jnp.asarray(logits))),
                           np.asarray(aw), np.asarray(dw)], axis=-1)


@pytest.mark.parametrize('dtype,jdtype,atol', [
    (torch.float32, jnp.float32, 1e-4),
    (torch.bfloat16, jnp.bfloat16, 2e-2)])
def test_fusion_matches_jax(tree, dtype, jdtype, atol):
    args = _inputs()
    want = _packed(*JaxFusion(**CFG, dtype=jdtype).apply(tree, *args))
    model = MultiModalFusionModel(**CFG, dtype=dtype)
    model.load_state_dict(fusion_state_from_jax(tree))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    assert [t.dtype for t in got] == [torch.float32] * 3
    got = _packed(*(t.numpy() for t in got))
    assert got.shape == (5, 13)
    np.testing.assert_allclose(got, want, atol=atol)
    np.testing.assert_allclose(got[:, 7:10].sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got[:, 10:].sum(-1), 1.0, atol=1e-5)


def test_fusion_in_proj_stays_fp32_in_bf16(tree):
    model = MultiModalFusionModel(**CFG, dtype=torch.bfloat16)
    model.load_state_dict(fusion_state_from_jax(tree))
    mha = model.cross_attn_text.attention
    assert mha.in_proj_weight.dtype == torch.float32
    assert mha.out_proj.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mha.in_proj_weight.detach().numpy(),
        tree['params']['cross_attn_text']['attention']['in_proj_weight'])


def test_synthetic_fusion_tree_matches_flax_init():
    ref = JaxFusion(**CFG).init(jax.random.PRNGKey(0),
                                *(jnp.zeros((1, d)) for d in
                                  (64, 64, 512, 7, 7, 7)))
    got = fusion_variables(0, speech_dim=64, text_dim=64, image_dim=512)
    assert jax.tree_util.tree_map(np.shape, got) == \
        jax.tree_util.tree_map(np.shape, {'params': ref['params']})
    full = fusion_variables(0)
    assert full['params']['text_proj']['linear']['kernel'].shape == (768, 256)
