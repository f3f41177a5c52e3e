"""Rank functions for tests/test_torch_parallel.py's two-rank spawns.

parallel.launch starts fresh processes and imports these by name, so
they live in a module that imports torch and the port only (a test
module imports jax). Each runs inside an initialized gloo group; the
single-process references run in the parent, on the same numpy-seeded
inputs made by the same functions here.
"""

import functools

import numpy as np
import torch

from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.models.fusion import MultiModalFusionModel
from mec_tpu_torch.models.speech_dnn import SpeechDNN
from mec_tpu_torch.parallel import mesh as pmesh
from mec_tpu_torch.training import (common, train_fusion, train_speech,
                                    train_text_bert)

GLOBAL_B = 8
FUSION_KW = dict(speech_dim=8, text_dim=12, image_dim=10, hidden_dim=16)
MOE_KW = dict(vocab_size=50, hidden_size=16, num_layers=2, num_heads=2,
              intermediate_size=32, max_position=32, num_experts=2,
              moe_capacity_factor=1.0)


class RecordingTx(common.Tx):
    """adam_with_clip that keeps the gradients it is handed (after the
    data-parallel all-reduce)."""

    def __init__(self):
        super().__init__({'all': common.Adam(1e-3)})

    def step(self, grads, state, params, norm_fn=None):
        self.grads = [g.detach().clone() for g in grads]
        super().step(grads, state, params, norm_fn)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def grad_case(name):
    """(float64 model at its seeded init, train_step, global batch)."""
    rng = np.random.RandomState(3)
    if name == 'speech':
        model = SpeechDNN()
        step = train_speech.make_steps
        batch = {'x': rng.randn(GLOBAL_B, 56),
                 'label': np.eye(7)[rng.randint(0, 7, GLOBAL_B)]}
    elif name == 'fusion':
        model = MultiModalFusionModel(**FUSION_KW, dtype=torch.float64)
        step = train_fusion.make_steps
        probs = rng.dirichlet(np.ones(7), (3, GLOBAL_B))
        batch = {'s_feat': rng.randn(GLOBAL_B, 8),
                 't_feat': rng.randn(GLOBAL_B, 12),
                 'i_feat': rng.randn(GLOBAL_B, 10),
                 's_pred': probs[0], 't_pred': probs[1], 'i_pred': probs[2],
                 'label': rng.randint(0, 7, GLOBAL_B)}
    else:
        model = BertForSequenceClassification(**MOE_KW, dtype=torch.float64)
        step = functools.partial(train_text_bert.make_steps, bf16=False)
        mask = np.ones((GLOBAL_B, 12), np.int32)
        mask[np.arange(GLOBAL_B), rng.randint(3, 12, GLOBAL_B)] = 0
        mask = np.cumprod(mask, axis=1)
        batch = {'ids': rng.randint(5, 50, (GLOBAL_B, 12)) * mask,
                 'mask': mask, 'label': rng.randint(0, 7, GLOBAL_B)}
    model = _no_dropout(common.flax_init(model, 0).double())
    return model, step(model)[0], batch


def one_step(name, mesh=None):
    """One training step of case `name` on this rank's rows (all rows
    without a mesh): the loss, the gradients the optimizer got, the
    module's state after the step."""
    model, train_step, batch = grad_case(name)
    if mesh is not None:
        batch = mesh.shard_rows(batch)
    state = common.TrainState(model, RecordingTx())
    model.train()
    with pmesh.data_parallel(mesh):
        loss = train_step(state, common.to_device(batch, 'cpu'))
    return {'loss': float(loss.detach()),
            'grads': [g.numpy() for g in state.tx.grads],
            'state': {k: v.numpy() for k, v in state.variables.items()}}


FIT_ROWS, FIT_BATCH = 26, 8


def fit_data():
    """Fusion rows whose first feature is the row number, so a batch
    names its rows; 26 rows in batches of 8 leave a ragged tail of 2."""
    rng = np.random.RandomState(5)
    n = FIT_ROWS + 11
    data = {'s_feat': rng.randn(n, 8).astype(np.float32),
            't_feat': rng.randn(n, 12).astype(np.float32),
            'i_feat': rng.randn(n, 10).astype(np.float32),
            's_pred': rng.dirichlet(np.ones(7), n).astype(np.float32),
            't_pred': rng.dirichlet(np.ones(7), n).astype(np.float32),
            'i_pred': rng.dirichlet(np.ones(7), n).astype(np.float32),
            'label': rng.randint(0, 7, n)}
    data['s_feat'][:, 0] = np.arange(n)
    return ({k: v[:FIT_ROWS] for k, v in data.items()},
            {k: v[FIT_ROWS:] for k, v in data.items()})


def _fusion_fit(mesh, epochs, **kw):
    """A fusion fit from the seeded init over fit_data; its train_step
    records the rows it is given. (rows, state, best, history)"""
    train, val = fit_data()
    model = common.flax_init(MultiModalFusionModel(**FUSION_KW), 0)
    state = common.TrainState(model, common.adam_with_clip(1e-3))
    inner = train_fusion.make_steps(model)
    rows = []

    def train_step(st, batch):
        rows.append(batch['s_feat'][:, 0].long().tolist())
        return inner[0](st, batch)

    return (rows, *common.fit(state, train, val, train_step, inner[1],
                              epochs=epochs, batch_size=FIT_BATCH, seed=4,
                              log_fn=lambda *_: None, mesh=mesh, **kw))


def dp_checks(ckpt):
    """Every check of one rank: the three cases' steps; a 3-epoch fusion
    fit; the same fit stopped after 2 epochs with a checkpoint at `ckpt`
    (rank 0 writes it) and resumed on every rank to 3."""
    mesh = common.data_mesh(2)
    out = {name: one_step(name, mesh) for name in ('speech', 'fusion',
                                                   'moe_bert')}
    rows, state, best, history = _fusion_fit(mesh, 3)
    _fusion_fit(mesh, 2, checkpoint_path=ckpt)
    _r, resumed, _b, rhistory = _fusion_fit(mesh, 3, checkpoint_path=ckpt,
                                            resume=True)
    out.update(rows=rows, history=history,
               params=[p.detach().numpy().copy() for p in state.params],
               best={k: v.numpy() for k, v in best.items()},
               resumed=[p.detach().numpy().copy() for p in resumed.params],
               resumed_history=rhistory)
    return out


def train_speech_rank(X, y, init, epochs, batch_size, models_dir):
    """train_speech.train(mesh_data=2) on this rank from the Flax tree
    `init`, dropout off."""
    from mec_tpu_torch.convert.from_jax import state_dict_from_jax

    def from_jax(model, seed):
        model.load_state_dict(state_dict_from_jax(model, init))
        return _no_dropout(model)

    common.flax_init = from_jax
    return train_speech.train(X=X, y=y, epochs=epochs,
                              batch_size=batch_size, mesh_data=2,
                              models_dir=models_dir, verbose=False,
                              device='cpu')[2]


# ----------------------------------------------------------------------
# the model and pipe axes (tests/test_torch_pipeline.py: four gloo ranks)
# ----------------------------------------------------------------------

LAYOUT_KW = dict(vocab_size=50, hidden_size=16, num_layers=4, num_heads=4,
                 intermediate_size=32, max_position=32)
LAYOUT_B, LAYOUT_L = 8, 8
# (dp, tp, pp, microbatches, seq_parallel, experts): world 4 each
LAYOUTS = [(2, 1, 2, 2, False, 0), (1, 2, 2, 2, False, 0),
           (2, 2, 1, 0, False, 0), (1, 4, 1, 0, True, 0),
           (2, 2, 1, 0, False, 2)]


def layout_batch():
    """A seeded global batch with ragged masks (row 0 full)."""
    rng = np.random.RandomState(7)
    B, L = LAYOUT_B, LAYOUT_L
    lengths = np.concatenate([[L], rng.randint(2, L + 1, B - 1)])
    mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
    return {'ids': rng.randint(5, 50, (B, L)).astype(np.int32) * mask,
            'mask': mask, 'label': rng.randint(0, 7, B)}


def layout_model(dtype, experts=0):
    """The seeded tiny BERT (MoE with `experts`), dropout off."""
    kw = dict(LAYOUT_KW, dtype=dtype)
    if experts:
        kw.update(num_experts=experts, moe_capacity_factor=2.0)
    model = common.flax_init(BertForSequenceClassification(**kw), 0)
    return _no_dropout(model.to(dtype))


class NormTx(RecordingTx):
    """RecordingTx that also keeps the clip's global norm."""

    def step(self, grads, state, params, norm_fn=None):
        self.norm = float((norm_fn or common.global_norm)(grads))
        super().step(grads, state, params, norm_fn)


def layout_step(model, batch, mesh=None, microbatches=0):
    """One float64 training step: (loss, {name: the gradient the optimizer
    was handed}, the clip's norm)."""
    from mec_tpu_torch.parallel import pipeline
    state = common.TrainState(model, NormTx())
    model.train()
    if mesh is not None and mesh.pipe > 1:
        step = pipeline.make_pipeline_steps(model, mesh, microbatches)[0]
    else:
        step = train_text_bert.make_steps(model)[0]
    with pmesh.data_parallel(mesh):
        loss = step(state, common.to_device(batch, 'cpu'))
    return (float(loss.detach()), dict(zip(state.names, state.tx.grads)),
            state.tx.norm)


def layout_checks():
    """Every layout of LAYOUTS on this rank: the fp32 forward's logits of
    this data rank's rows, and the float64 step's loss, gradients
    gathered to the whole tree and clip norm."""
    from mec_tpu_torch.parallel import partition, pipeline
    out = []
    for dp, tp, pp, M, sp, experts in LAYOUTS:
        mesh = pmesh.make_mesh(dp, tp, pp)
        batch = mesh.shard_rows(layout_batch())
        model = layout_model(torch.float32, experts)
        partition.shard_bert(model, mesh, sp)
        pipeline.split_stages(model, mesh)
        dev = common.to_device(batch, 'cpu')
        with torch.no_grad():
            logits = (pipeline.pipeline_step(model, dev, mesh, M) if pp > 1
                      else model(dev['ids'], dev['mask'])[0])
        model = layout_model(torch.float64, experts)
        partition.shard_bert(model, mesh, sp)
        pipeline.split_stages(model, mesh)
        loss, grads, norm = layout_step(model, batch, mesh, M)
        full = partition.gather_state(model, grads)
        out.append({'logits': logits.numpy(), 'loss': loss, 'norm': norm,
                    'grads': {k: v.numpy() for k, v in full.items()},
                    'rank': (mesh.rank, mesh.model_rank, mesh.pipe_rank)})
    return out


TRAIN_TINY = dict(hidden_size=32, num_layers=2, num_heads=2,
                  intermediate_size=64)
# the BERT trainer's layouts on four ranks (the JAX package's
# tests/test_parallel_serving.py flags); the first starts from JAX's
# initial parameters with dropout off
TRAIN_RUNS = [dict(mesh_data=2, mesh_model=2),
              dict(mesh_data=2, mesh_pipe=2, microbatches=2),
              dict(mesh_data=2, mesh_model=2, seq_parallel=True),
              dict(mesh_data=2, mesh_model=2, experts=2)]


def text_corpus():
    from mec_tpu_torch.training import corpora
    texts, labels = corpora.make_text_corpus(per_class=6)
    return texts, labels, corpora.make_bert_tokenizer(texts)


def train_bert_runs(root, init):
    """train_text_bert.train for each of TRAIN_RUNS on this rank, the
    first from the Flax tree `init` with dropout off: [(variables,
    history)], and each run's directory under root."""
    from mec_tpu_torch.convert.from_jax import state_dict_from_jax
    texts, labels, tok = text_corpus()
    flax_init = common.flax_init

    def from_jax(model, seed):
        model.load_state_dict(state_dict_from_jax(model, init))
        return _no_dropout(model)

    out = []
    for i, flags in enumerate(TRAIN_RUNS):
        common.flax_init = from_jax if i == 0 else flax_init
        try:
            out.append(train_text_bert.train(
                csv_path=None, texts=texts, labels=labels, tokenizer=tok,
                epochs=2, batch_size=16, max_length=16, learning_rate=5e-4,
                model_kwargs=dict(TRAIN_TINY, vocab_size=len(tok.vocab)),
                models_dir=f'{root}/{i}', verbose=False, device='cpu',
                **flags))
        finally:
            common.flax_init = flax_init
    return out
