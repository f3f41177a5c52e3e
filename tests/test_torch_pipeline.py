"""The port's model and pipe axes (mec_tpu_torch/parallel/partition.py,
pipeline.py) against one process and against the JAX package.

One spawn of four gloo ranks on the CPU (one torch thread a rank, the
rank functions in tests/torch_parallel_workers.py) runs every layout of
workers.LAYOUTS, (dp, tp, pp, microbatches): (2, 1, 2, 2) and
(1, 2, 2, 2) through the hand-written GPipe schedule, (2, 2, 1) Megatron
tensor parallelism, (1, 4, 1) with sequence parallelism, and (2, 2, 1)
with a two-expert MoE BERT whose bank splits over 'model' (expert
parallelism). Tolerances, each with its reason:

* the fp32 forward's logits of each data rank's rows against the JAX
  model's apply on the same seeded parameters (and, for the pipelined
  layouts, against mec_tpu.parallel.pipeline.bert_pipeline_forward on
  the conftest's virtual CPU devices): 1e-5, the JAX pipeline test's own
  (tests/test_pipeline.py:56; measured <= 7.5e-07: the collectives sum
  partial products in another order);
* the float64 gradients the optimizer is handed (after the data mean and
  the sums of partial gradients), gathered to the whole tree, against
  one process on the same global batch: 1e-10 (measured <= 8.9e-16,
  the norm <= 1.8e-15);
  the mean of the data ranks' losses and the clip's global norm against
  one process's: 1e-10;
* stack_layer_params / unstack_layer_params against JAX's: exact.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.models.bert import BertForSequenceClassification as JaxBert
from mec_tpu.parallel import make_mesh as jax_make_mesh
from mec_tpu.parallel import pipeline as jpipeline
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.parallel import launch, pipeline

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as workers  # noqa: E402


def test_stack_unstack_match_jax():
    rng = np.random.RandomState(0)
    f32 = lambda *shape: rng.randn(*shape).astype(np.float32)  # noqa
    params = {f'layer_{i}': {'a': {'kernel': f32(3, 4)}, 'b': f32(5)}
              for i in range(4)}
    params['pooler'] = {'kernel': f32(2, 2)}
    got = pipeline.stack_layer_params(params, 4)
    want = jpipeline.stack_layer_params(params, 4)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        got, want)
    back = pipeline.unstack_layer_params(got)
    assert sorted(back) == [f'layer_{i}' for i in range(4)]
    for i in range(4):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               back[f'layer_{i}'], params[f'layer_{i}'])
    with pytest.raises(ValueError, match='do not split over 3'):
        pipeline.stage_layers(4, 3, 0)


def _jax_logits(variables, batch, experts, layout):
    kw = dict(workers.LAYOUT_KW)
    if experts:
        kw.update(num_experts=experts, moe_capacity_factor=2.0)
    model = JaxBert(**kw)
    ids, mask = jnp.asarray(batch['ids']), jnp.asarray(batch['mask'])
    out = [np.asarray(model.apply(variables, ids, mask)[0])]
    dp, tp, pp, M = layout
    if pp > 1:
        mesh = jax_make_mesh(data=dp, model=tp, pipe=pp)
        out.append(np.asarray(jax.jit(
            lambda v, i, m: jpipeline.bert_pipeline_forward(
                model, v, i, m, mesh, M))(variables, ids, mask)[0]))
    return out


def test_model_and_pipe_axes_match_one_process():
    ranks = launch.launch(workers.layout_checks, 4, devices=['cpu'] * 4,
                          threads=1, timeout=300)
    batch = workers.layout_batch()
    for i, (dp, tp, pp, M, sp, experts) in enumerate(workers.LAYOUTS):
        what = f'dp={dp} tp={tp} pp={pp} M={M} sp={sp} experts={experts}'
        refs = _jax_logits(to_jax(workers.layout_model(torch.float32,
                                                       experts)),
                           batch, experts, (dp, tp, pp, M))
        per = workers.LAYOUT_B // dp
        loss, grads, norm = workers.layout_step(
            workers.layout_model(torch.float64, experts), batch)
        losses = {}
        for r in ranks:
            got = r[i]
            d = got['rank'][0]
            for ref in refs:
                np.testing.assert_allclose(got['logits'],
                                           ref[d * per:(d + 1) * per],
                                           atol=1e-5, rtol=0, err_msg=what)
            assert sorted(got['grads']) == sorted(grads), what
            for k, g in grads.items():
                np.testing.assert_allclose(got['grads'][k], g.numpy(),
                                           atol=1e-10, rtol=0,
                                           err_msg=f'{what} {k}')
            assert abs(got['norm'] - norm) <= 1e-10, what
            losses[d] = got['loss']
        assert len(losses) == dp
        assert abs(np.mean(list(losses.values())) - loss) <= 1e-10, what
