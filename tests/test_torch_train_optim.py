"""The port's optimizers against optax, on identical gradients.

Each case feeds the same numpy-seeded gradients to the JAX package's
optimizer (mec_tpu.training.common / train_image.make_tx, which are
optax) inside its TrainState and to the port's (mec_tpu_torch.training.
common) inside its TrainState, for 5 updates, and compares the
parameters and the injected learning rate after every update. The
gradients' global norms straddle the clip (0.3 to 3). Adam's
m / (sqrt(v) + eps) turns any gradient far above eps into a step of
about lr, so the two can be held tightly only on identical gradients,
which is what this file does; the models' gradients are held to
jax.value_and_grad in tests/test_torch_train_grads.py.

Tolerance: parameters within 5e-7 absolute, two float32 ulps at the
parameters' magnitude (up to 2) and 5e-4 of a step of lr 1e-3 (measured:
one ulp, 1.2e-7, where the moments and the bias correction round in
other orders and p + u lands on the other side of a rounding boundary);
the learning rate within 1e-6 relative (measured 3e-7: float32 cos).
The schedules are also held to optax's at every count of a run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from mec_tpu.training import common as jcommon
from mec_tpu.training.train_image import make_tx as jax_make_tx
from mec_tpu_torch.training import common
from mec_tpu_torch.training.train_fusion import warm_restarts
from mec_tpu_torch.training.train_image import make_tx


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


SHAPES = {'fc1': {'weight': (4, 6), 'bias': (4,)},
          'body': {'weight': (3, 5), 'bias': (3,)}}
ATOL = 5e-7


class Holder(nn.Module):
    def __init__(self, params):
        super().__init__()
        for name, leaves in params.items():
            sub = nn.Module()
            for k, v in leaves.items():
                sub.register_parameter(k, nn.Parameter(
                    torch.from_numpy(v.copy())))
            self.add_module(name, sub)


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
            for m, d in SHAPES.items()}


def _grads(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
             for m, d in SHAPES.items()}
        norm = np.sqrt(sum((a ** 2).sum() for a in jax.tree.leaves(g)))
        target = (0.3, 3.0, 0.9, 1.5, 0.5)[i % 5]
        out.append(jax.tree.map(lambda a: a * np.float32(target / norm), g))
    return out


def _run(jax_tx, port_tx, steps, set_lr_at=None):
    params = _params()
    jstate = jcommon.TrainState.create({'params': params}, jax_tx)
    holder = Holder(params)
    pstate = common.TrainState(holder, port_tx)
    named = dict(holder.named_parameters())
    for i, g in enumerate(_grads(steps)):
        if set_lr_at == i:
            new = jcommon.get_lr(jstate) * 0.5
            jstate = jcommon.set_lr(jstate, new)
            common.set_lr(pstate, new)
        jstate = jstate.apply_gradients(g)
        for m, d in g.items():
            for k, v in d.items():
                named[f'{m}.{k}'].grad = torch.from_numpy(v.copy())
        pstate.apply_gradients()
        for m, d in jstate.params.items():
            for k, v in d.items():
                np.testing.assert_allclose(
                    named[f'{m}.{k}'].detach().numpy(), np.asarray(v),
                    rtol=0, atol=ATOL, err_msg=f'update {i} {m}.{k}')
        jlr, plr = jcommon.get_lr(jstate), common.get_lr(pstate)
        if np.isnan(jlr):
            assert np.isnan(plr)
        else:
            np.testing.assert_allclose(plr, jlr, rtol=1e-6)


def _cosine(steps):
    return (optax.cosine_decay_schedule(1e-2, steps),
            common.cosine_decay_schedule(1e-2, steps))


CASES = {
    'adam_with_clip': lambda: (jcommon.adam_with_clip(1e-3),
                               common.adam_with_clip(1e-3), 5, None),
    'adamw_cosine': lambda: (jcommon.adamw_with_clip(_cosine(5)[0]),
                             common.adamw_with_clip(_cosine(5)[1]), 5, None),
    'make_tx_frozen': lambda: (jax_make_tx(1e-3, 1e-2, True),
                               make_tx(1e-3, 1e-2, True), 5, None),
    'make_tx_unfrozen': lambda: (jax_make_tx(1e-3, 1e-2, False),
                                 make_tx(1e-3, 1e-2, False), 5, None),
    'multisteps_2': lambda: (
        optax.MultiSteps(jcommon.adamw_with_clip(_cosine(5)[0]), 2),
        common.multi_steps(common.adamw_with_clip(_cosine(5)[1]), 2),
        10, None),
    'set_lr_midstream': lambda: (jcommon.adam_with_clip(1e-3),
                                 common.adam_with_clip(1e-3), 5, 2),
}


@pytest.mark.parametrize('name', list(CASES))
def test_optimizer_matches_optax(name):
    jax_tx, port_tx, steps, set_lr_at = CASES[name]()
    _run(jax_tx, port_tx, steps, set_lr_at)


def test_schedules_match_optax():
    total = 40
    warm = total // 10
    pairs = [
        (optax.join_schedules([optax.linear_schedule(0.0, 5e-4, warm),
                               optax.linear_schedule(5e-4, 0.0,
                                                     total - warm)],
                              [warm]),
         common.join_schedules([common.linear_schedule(0.0, 5e-4, warm),
                                common.linear_schedule(5e-4, 0.0,
                                                       total - warm)],
                               [warm])),
        _cosine(total),
    ]
    # the fusion trainer's warm restarts: 35 epochs of 3 updates, T_0 10,
    # T_mult 2 (spans 10, 20, 5), as JAX train_fusion builds it
    spans, bounds, t, seen = [], [], 10, 0
    while seen < 35:
        spans.append(optax.cosine_decay_schedule(1e-3, min(t, 35 - seen) * 3))
        seen += t
        bounds.append(seen * 3)
        t *= 2
    pairs.append((optax.join_schedules(spans, bounds[:-1]),
                  warm_restarts(1e-3, 35, 3)))
    for want, got in pairs:
        for c in range(120):
            np.testing.assert_allclose(got(c), float(want(jnp.asarray(c))),
                                       rtol=1e-6, atol=1e-12,
                                       err_msg=f'count {c}')


def test_optimizer_total_steps_matches_jax():
    for args in ((71, 16, 8, 1), (71, 16, 8, 3), (64, 16, 5, 2),
                 (1, 64, 1, 1)):
        assert common.optimizer_total_steps(*args) == \
            jcommon.optimizer_total_steps(*args)


def test_clip_is_optax_not_clip_grad_norm():
    """At a norm of exactly 1.0 optax leaves the gradient alone and
    scales by max / norm above it; torch's clip_grad_norm_ divides by
    norm + 1e-6."""
    tx = common.Tx({'all': None}, clipnorm=1.0)
    g = [torch.full((4,), 0.5)]
    assert torch.equal(tx._clip(g)[0], g[0])
    big = [torch.full((4,), 2.0)]
    want = np.asarray(optax.clip_by_global_norm(1.0).update(
        [jnp.full((4,), 2.0)], optax.EmptyState())[0][0])
    np.testing.assert_allclose(tx._clip(big)[0].numpy(), want, rtol=1e-7)
