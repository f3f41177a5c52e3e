"""The port's tensor, sequence and expert parallelism
(mec_tpu_torch/parallel/partition.py) and the BERT trainer over the
model and pipe axes, against the JAX package.

* bert_partition_rules / partition_spec_for: every leaf of the JAX BERT
  and MoE BERT trees gets JAX's spec (a spec is the tuple of a
  PartitionSpec), exactly;
* shard_bert on each 'model' rank of 2 and 4 (dense and MoE BERT):
  every leaf, in the Flax layout, is exactly the rank's block of JAX's
  placement by those rules, or the whole leaf where JAX falls back;
* the rank layout: rank r sits where JAX's make_mesh puts device r
  (devs.reshape(data, model, pipe)), exactly;
* one spawn of four gloo ranks on the CPU runs train_text_bert.train
  with each of workers.TRAIN_RUNS (--mesh-data 2 with --mesh-model 2,
  --mesh-pipe 2 --microbatches 2, --mesh-model 2 --seq-parallel, and
  --mesh-model 2 --experts 2, the JAX package's
  tests/test_parallel_serving.py flags). Every rank returns the same
  whole tree and history. Each written directory, served by the port's
  engine on the CPU in fp32, gives the trainer's own eval probabilities
  within 2e-4 (the JAX test's band; measured <= 1.8e-08). The first
  run starts from the JAX trainer's initial parameters with dropout off
  on both sides, and its training loss follows the JAX trainer's same
  flags run within 1e-3 relative over two epochs (the band of
  tests/test_torch_parallel.py, for the same reason: fp32 summation
  orders differ and Adam turns the noise into steps; measured
  <= 5.0e-07), val_acc within one validation row;
* without a process group each layout raises the mesh's RuntimeError,
  naming the group it needs.
"""

import os
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from examples.end_to_end import make_bert_tokenizer as jax_tokenizer
from mec_tpu.parallel import make_mesh as jax_make_mesh
from mec_tpu.parallel import partition as jpartition
from mec_tpu.models.bert import BertForSequenceClassification as JaxBert
from mec_tpu.training import common as jcommon
from mec_tpu.training import train_text_bert as jax_bert_trainer
from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.from_jax import bert_state_from_jax
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.convert.hf_config import (model_kwargs_from_config,
                                             read_config)
from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.parallel import launch, partition
from mec_tpu_torch.parallel import mesh as pmesh
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as workers  # noqa: E402



@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """Six tier-1 workers share the CPU: two torch threads a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _paths(tree):
    out = []
    for kp, _leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append(tuple(str(getattr(k, 'key', k)) for k in kp))
    return out


@pytest.mark.parametrize('experts', [0, 4])
def test_partition_rules_match_jax(experts):
    model = JaxBert(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, intermediate_size=64, max_position=32,
                    num_experts=experts)
    ids = np.ones((1, 8), np.int32)
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                  ids, ids))
    paths = _paths(variables) + [
        ('params', 'layer_3', 'attention_self_query', 'kernel'),
        ('params', 'layer_0', 'output', 'bias'), ('params', 'output')]
    jrules, rules = jpartition.bert_partition_rules(), \
        partition.bert_partition_rules()
    assert len(rules) == len(jrules)
    sharded = 0
    for path in paths:
        want = tuple(jpartition.partition_spec_for(path, jrules))
        assert partition.partition_spec_for(path, rules) == want, path
        sharded += bool(want)
    # two layers' q, k, v kernels and biases and attention_output kernel,
    # and the intermediate and output kernels and bias or the expert
    # bank; and the spelled-out query path
    assert sharded == 2 * (7 + (4 if experts else 3)) + 1


class _ModelAxis:
    """The TensorParallel shard_bert hands the layers, without a group:
    the rank's place on 'model' is all the slicing reads."""

    def __init__(self, mesh, seq=False):
        self.size, self.rank, self.seq = mesh.model, mesh.model_rank, seq


@pytest.mark.parametrize('experts,size', [(0, 2), (0, 4), (4, 2), (2, 4)])
def test_shard_bert_places_leaves_as_jax(experts, size, monkeypatch):
    """Every leaf shard_bert leaves on each 'model' rank, in the Flax
    layout, is exactly JAX's placement of the whole tree: the rank's
    block of a leaf whose spec names 'model' where the dimension divides,
    else the whole leaf (JAX's per-leaf fallback: 2 experts over 4)."""
    monkeypatch.setattr(partition, 'TensorParallel', _ModelAxis)
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position=32, num_experts=experts)
    ids = np.ones((1, 8), np.int32)
    variables = JaxBert(**kw).init(jax.random.PRNGKey(0), ids, ids)
    leaves = jax.tree_util.tree_flatten_with_path(variables)[0]
    rules = jpartition.bert_partition_rules()
    for r in range(size):
        model = BertForSequenceClassification(**kw)
        model.load_state_dict(bert_state_from_jax(variables))
        partition.shard_bert(model, pmesh.DataMesh(
            rank=0, size=1, model=size, model_rank=r))
        got = dict(zip(_paths(variables), jax.tree_util.tree_leaves(
            to_jax(model))))
        for path, (_kp, leaf) in zip(_paths(variables), leaves):
            want = np.asarray(leaf)
            spec = tuple(jpartition.partition_spec_for(path, rules))
            if pmesh.MODEL_AXIS in spec:
                d = spec.index(pmesh.MODEL_AXIS)
                if want.shape[d] % size == 0:
                    want = np.split(want, size, axis=d)[r]
            np.testing.assert_array_equal(got[path], want, err_msg=path)


@pytest.mark.parametrize('data,model,pipe', [
    (2, 2, 2), (2, 1, 4), (1, 2, 4), (4, 2, 1), (8, 1, 1), (1, 8, 1)])
def test_rank_layout_matches_jax_make_mesh(data, model, pipe):
    mesh = jax_make_mesh(data=data, model=model, pipe=pipe)
    grid = np.vectorize(lambda d: d.id)(mesh.devices).reshape(
        data, model, pipe)
    for r in range(data * model * pipe):
        d, m, p = pmesh.mesh_place(r, model, pipe)
        assert grid[d, m, p] == r
        place = pmesh.DataMesh(rank=d, size=data, model=model, pipe=pipe,
                               model_rank=m, pipe_rank=p)
        assert place.global_rank == r


def test_layouts_need_their_group():
    for sizes, n in (((1, 2, 1), 2), ((1, 1, 2), 2), ((2, 2, 2), 8)):
        with pytest.raises(RuntimeError, match=f'needs a torch.distributed '
                                               f'group of {n} ranks'):
            pmesh.make_mesh(*sizes)


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def test_bert_trainer_layouts_serve(tmp_path, monkeypatch):
    texts, labels, tok = workers.text_corpus()
    # the JAX trainer's --mesh-data 2 --mesh-model 2 run, dropout off,
    # its initial parameters kept
    init = {}
    fit = jcommon.fit

    def spy(state, *a, **k):
        init['params'] = jax.tree.map(np.asarray, state.params)
        return fit(state, *a, **k)

    monkeypatch.setattr(jcommon, 'fit', spy)
    monkeypatch.setattr(fnn.Dropout, '__call__',
                        lambda self, inputs, *a, **k: inputs)
    jtok = jax_tokenizer(texts)
    _v, want = jax_bert_trainer.train(
        csv_path=None, texts=texts, labels=labels, tokenizer=jtok,
        epochs=2, batch_size=16, max_length=16, learning_rate=5e-4,
        model_kwargs=dict(workers.TRAIN_TINY, vocab_size=len(jtok.vocab)),
        models_dir=str(tmp_path / 'jax'), verbose=False,
        **workers.TRAIN_RUNS[0])
    ranks = launch.launch(workers.train_bert_runs, 4,
                          args=(str(tmp_path), init), devices=['cpu'] * 4,
                          threads=1, timeout=400)
    for r in ranks[1:]:
        for (v, h), (v0, h0) in zip(r, ranks[0]):
            assert h == h0
            jax.tree_util.tree_map(np.testing.assert_array_equal, v, v0)
    got = ranks[0][0][1]
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-3)
    np.testing.assert_allclose(got['val_acc'], want['val_acc'], rtol=0,
                               atol=1 / 13 + 1e-9)
    probes = list(texts[::11][:5])
    ids, mask = tok.encode_batch(probes, Config.MAX_TEXT_LENGTH)
    for i, (variables, _h) in enumerate(ranks[0]):
        d = str(tmp_path / str(i))
        kwargs = model_kwargs_from_config(read_config(d))
        model = BertForSequenceClassification(**kwargs)
        model.load_state_dict(bert_state_from_jax(variables))
        with torch.no_grad():
            expected = _softmax(model(torch.from_numpy(np.asarray(ids)),
                                      torch.from_numpy(np.asarray(mask)))[0]
                                .double().numpy())
        engine = EmotionEngine(
            bert_variables=store.load_params(
                os.path.join(d, 'bert_model.mecp'))['variables'],
            bert_kwargs=kwargs,
            bert_vocab=WordPieceTokenizer.from_pretrained_dir(d),
            compute_dtype='float32', device='cpu')
        served = np.array([r['all_probabilities']
                           for r in engine.predict_texts(probes)])
        np.testing.assert_allclose(served, expected, atol=2e-4,
                                   err_msg=str(workers.TRAIN_RUNS[i]))
        assert kwargs.get('num_experts', 0) == \
            workers.TRAIN_RUNS[i].get('experts', 0)
