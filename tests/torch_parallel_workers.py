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

    def step(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        super().step(grads, state, params)


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
