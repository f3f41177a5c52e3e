"""Training mechanics of the port: fit, checkpoints, remat, accumulation,
the BatchNorm update.

* fit's batch order is JAX's iterate_batches order under the JAX
  per-(seed, epoch) RandomState, ragged tail included;
* a run interrupted after 2 epochs and resumed from its checkpoint ends
  bit for bit where the uninterrupted run ends (state, best variables,
  history); a resume with no epoch left returns the checkpoint's best
  variables (the counterparts of tests/test_training.py:293-337);
* the checkpoint's magic differs from the JAX package's, both ways;
* remat recomputes with the same dropout masks and updates the BatchNorm
  statistics once: gradients and statistics bit-equal without it (the
  counterpart of tests/test_training.py:412 and :470);
* grad-accum k=2 over two half batches hands the optimizer the
  full-batch gradient (within 1e-6: a mean of two means against one
  mean), and applies one update per two calls;
* the BatchNorm step is Flax's: the running statistics after one step
  equal flax.linen.BatchNorm's (within 1e-6 of the largest), and torch's
  own nn.BatchNorm update misses them (unbiased variance);
* what is not ported raises naming its ROADMAP item, --mesh-data
  without its process group raises, device='cuda' without a card
  raises, and --pretrained-dir's bert_model.mecp initialises every node
  but the classifier.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mec_tpu.training import checkpoint as jax_checkpoint
from mec_tpu.training import common as jcommon
from mec_tpu_torch.models.batchnorm import BatchNorm1d
from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.models.mobilenet import MobileNetV2EmotionModel
from mec_tpu_torch.models.resnet import ImageEmotionModel
from mec_tpu_torch.training import (checkpoint, common, train_image,
                                    train_speech, train_text_bert)


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


def _speech_data(n=84, seed=0):
    rng = np.random.RandomState(seed)
    y = (np.arange(n) % 7).astype(np.int32)
    X = (rng.randn(n, 56) + y[:, None] * 0.4).astype(np.float32)
    return X, y


def test_fit_batch_order_matches_jax_iterate_batches():
    n, bs, seed = 23, 5, 7
    data = {'x': np.arange(n, dtype=np.float32)[:, None],
            'label': np.zeros(n, np.int32)}
    seen = []

    class Tiny(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.zeros(1))

    def train_step(state, batch):
        seen.append(batch['x'][:, 0].long().tolist())
        return torch.zeros(())

    state = common.TrainState(Tiny(), common.adam_with_clip(1e-3))
    common.fit(state, data, data, train_step,
               lambda s, b: torch.zeros(len(b['x']), 7), epochs=3,
               batch_size=bs, seed=seed, log_fn=lambda *_: None)
    want = []
    for epoch in range(3):
        rng = np.random.RandomState((seed * 1000003 + epoch) % 2**32)
        want += [b['x'][:, 0].astype(int).tolist() for b in
                 jcommon.iterate_batches(data, bs, rng)]
    assert seen == want
    assert [len(b) for b in seen[:5]] == [5, 5, 5, 5, 3]


def _vars_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    return all(np.array_equal(x, y) for x, y in zip(la, lb))


def test_resume_midrun_equals_uninterrupted(tmp_path):
    X, y = _speech_data()
    kw = dict(X=X, y=y, batch_size=16, verbose=False, device='cpu')
    full, _, hist_full = train_speech.train(
        epochs=4, models_dir=str(tmp_path / 'full'),
        checkpoint_path=str(tmp_path / 'full.ckpt'), **kw)
    ckpt = str(tmp_path / 'part.ckpt')
    _, _, hist_part = train_speech.train(
        epochs=2, models_dir=str(tmp_path / 'part'), checkpoint_path=ckpt,
        **kw)
    resumed, _, hist_res = train_speech.train(
        epochs=4, models_dir=str(tmp_path / 'res'), checkpoint_path=ckpt,
        resume=True, **kw)
    assert hist_res == hist_full and hist_res['val_acc'][:2] == \
        hist_part['val_acc']
    assert _vars_equal(resumed, full)
    with open(tmp_path / 'full' / 'speech_model.mecp', 'rb') as a, \
            open(tmp_path / 'res' / 'speech_model.mecp', 'rb') as b:
        assert a.read() == b.read()


def test_resume_with_no_new_best_keeps_checkpoint_best_vars(tmp_path):
    X, y = _speech_data()
    kw = dict(X=X, y=y, batch_size=16, verbose=False, device='cpu',
              checkpoint_path=str(tmp_path / 's.ckpt'))
    best1, _, _ = train_speech.train(epochs=3, models_dir=str(tmp_path / 'a'),
                                     **kw)
    best2, _, _ = train_speech.train(epochs=3, models_dir=str(tmp_path / 'b'),
                                     resume=True, **kw)
    assert _vars_equal(best1, best2)


def test_checkpoints_of_the_two_packages_do_not_mix(tmp_path):
    X, y = _speech_data()
    ckpt = str(tmp_path / 'port.ckpt')
    train_speech.train(X=X, y=y, epochs=1, batch_size=16, verbose=False,
                       device='cpu', models_dir=str(tmp_path / 'm'),
                       checkpoint_path=ckpt)
    with open(ckpt, 'rb') as f:
        assert f.read(len(checkpoint.MAGIC)) == checkpoint.MAGIC
    jstate = jcommon.TrainState.create({'params': {'w': jnp.zeros(2)}},
                                       jcommon.adam_with_clip(1e-3))
    with pytest.raises(ValueError, match='not a mec_tpu train checkpoint'):
        jax_checkpoint.restore_train_state(ckpt, jstate)
    jax_ckpt = str(tmp_path / 'jax.ckpt')
    jax_checkpoint.save_train_state(jax_ckpt, jstate, extra={'epoch': 0})
    state = common.TrainState(train_speech.SpeechDNN(),
                              common.adam_with_clip(1e-3))
    with pytest.raises(ValueError, match='JAX .* train checkpoint'):
        checkpoint.restore_train_state(jax_ckpt, state)
    os.makedirs(tmp_path / 'orbax')
    with pytest.raises(ValueError, match='orbax'):
        checkpoint.restore_train_state(str(tmp_path / 'orbax'), state)


class Record(common.Tx):
    """Records the (accumulated) gradients the update would apply."""

    def __init__(self, every_k=1):
        super().__init__({'all': None}, every_k=every_k)
        self.seen = []

    def _clip(self, grads, norm_fn=None):
        self.seen.append([g.clone() for g in grads])
        return grads


def _one_step(model, make_steps, batch, seed=5):
    model.train()
    tx = Record()
    state = common.TrainState(model, tx)
    train_step = make_steps(model)[0]
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        loss = train_step(state, common.to_device(batch, 'cpu'))
    stats = [b.clone() for n, b in model.named_buffers()
             if 'running' in n]
    return loss, tx.seen[0], stats


def _bert_batch():
    rng = np.random.RandomState(2)
    ids = rng.randint(1, 40, (4, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 6:] = 0
    return {'ids': ids, 'mask': mask, 'label': np.array([0, 1, 2, 3])}


def _image_batch(size):
    rng = np.random.RandomState(3)
    return {'img': rng.randint(0, 256, (4, size, size, 3)).astype(np.uint8),
            'label': np.array([0, 4, 5, 6])}


BERT_KW = dict(vocab_size=40, hidden_size=16, num_layers=2, num_heads=2,
               intermediate_size=32)


@pytest.mark.parametrize('name', ['bert', 'resnet50', 'mobilenet_v2'])
def test_remat_is_bit_exact(name):
    def build(remat):
        if name == 'bert':
            m = BertForSequenceClassification(**BERT_KW, remat=remat)
            return m, train_text_bert.make_steps, _bert_batch()
        cls = ImageEmotionModel if name == 'resnet50' else \
            MobileNetV2EmotionModel
        kw = {'stage_sizes': (1, 1, 1, 1)} if name == 'resnet50' else {}
        return cls(**kw, remat=remat), train_image.make_steps, \
            _image_batch(32)

    results = []
    for remat in (False, True):
        model, make_steps, batch = build(remat)
        common.flax_init(model, 0)
        results.append(_one_step(model, make_steps, batch))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert len(s0) == len(s1) and all(torch.equal(a, b)
                                      for a, b in zip(s0, s1))
    if name != 'bert':
        # the statistics moved once: ra = 0.9 * 0 + 0.1 * batch mean
        assert any(s.abs().max() > 0 for s in s1[::2])


def test_grad_accum_k2_equals_full_batch():
    batch = _bert_batch()
    halves = [{k: v[:2] for k, v in batch.items()},
              {k: v[2:] for k, v in batch.items()}]

    def run(tx, batches):
        model = common.flax_init(
            BertForSequenceClassification(**BERT_KW, dropout_rate=0.0), 0)
        model.train()
        state = common.TrainState(model, tx)
        step = train_text_bert.make_steps(model)[0]
        for b in batches:
            step(state, common.to_device(b, 'cpu'))
        return tx.seen

    full = run(Record(), [batch])
    acc = run(Record(every_k=2), halves)
    assert len(full) == len(acc) == 1
    for a, b in zip(acc[0], full[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)


def test_batchnorm_step_is_flax_not_torch():
    rng = np.random.RandomState(4)
    x = (rng.randn(6, 5) * 3 + 1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    v = bn.init(jax.random.PRNGKey(0), x)
    y, mut = bn.apply(v, x, mutable=['batch_stats'])
    want = mut['batch_stats']

    mine = BatchNorm1d(5, eps=1e-3, momentum=0.01).train()
    theirs = nn.BatchNorm1d(5, eps=1e-3, momentum=0.01).train()
    got_y = mine(torch.from_numpy(x)).detach().numpy()
    theirs(torch.from_numpy(x))
    np.testing.assert_allclose(got_y, np.asarray(y), atol=1e-5)
    for key, buf in (('mean', 'running_mean'), ('var', 'running_var')):
        np.testing.assert_allclose(getattr(mine, buf).numpy(),
                                   np.asarray(want[key]), rtol=1e-6)
    np.testing.assert_allclose(theirs.running_mean.numpy(),
                               np.asarray(want['mean']), rtol=1e-6)
    # torch's own step stores the unbiased batch variance: 6/5 of Flax's
    # batch share, which the trainers' statistics must not take
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(theirs.running_var.numpy(),
                                   np.asarray(want['var']), rtol=1e-4)
    batch_var = x.var(axis=0)
    np.testing.assert_allclose(theirs.running_var.numpy(),
                               0.99 + 0.01 * batch_var * 6 / 5, rtol=1e-5)


def test_trainers_refuse_what_is_not_ported(tmp_path):
    """--mesh-model, --mesh-pipe (and --seq-parallel with them) and
    --mesh-data above 1 without a process group of that size raise
    (never a silent run on one device); --seq-parallel without
    --mesh-model exits; an HF BERT directory whose weights do not
    convert raises (the JAX trainer falls back to random init, C5);
    device='cuda' without a card raises
    (never a silent CPU run)."""
    texts = np.array(['a b', 'c d'] * 7, dtype=object)
    labels = (np.arange(14) % 7).astype(np.int32)
    kw = dict(csv_path=None, texts=texts, labels=labels, verbose=False,
              device='cpu')
    # the model and pipe axes need their group; sequence parallelism
    # needs a model axis, as in JAX (tests/test_parallel.py:172)
    for bad in ({'mesh_model': 2}, {'mesh_pipe': 2},
                {'seq_parallel': True, 'mesh_model': 2}):
        with pytest.raises(RuntimeError, match='needs a torch.distributed '
                                               'group of 2 ranks'):
            train_text_bert.train(**kw, **bad)
    with pytest.raises(SystemExit, match='--seq-parallel requires '
                                         '--mesh-model > 1'):
        train_text_bert.train(**kw, seq_parallel=True)
    with pytest.raises(RuntimeError, match='needs a torch.distributed '
                                           'group of 4 ranks'):
        train_text_bert.train(**kw, mesh_data=4)
    with pytest.raises(RuntimeError, match='group of 2 ranks'):
        train_speech.train(X=np.zeros((7, 56), np.float32), y=labels[:7],
                           mesh_data=2, device='cpu', verbose=False)
    (tmp_path / 'pytorch_model.bin').write_bytes(b'')
    model = BertForSequenceClassification(**BERT_KW)
    with pytest.raises(EOFError):
        train_text_bert.init_from_pretrained(model, str(tmp_path))
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the no-card error cannot '
                    'occur')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_speech.train(X=np.zeros((7, 56), np.float32), y=labels[:7],
                           verbose=False)


def test_pretrained_dir_initialises_the_encoder(tmp_path):
    """A bert_model.mecp in --pretrained-dir gives every top-level node
    but the classifier; the classifier keeps its fresh init."""
    from mec_tpu_torch.convert import store
    from mec_tpu_torch.convert.to_jax import to_jax
    pre = common.flax_init(BertForSequenceClassification(**BERT_KW), 1)
    store.save_params(str(tmp_path / 'bert_model.mecp'), to_jax(pre))
    model = common.flax_init(BertForSequenceClassification(**BERT_KW), 2)
    fresh = to_jax(model)['params']['classifier']
    train_text_bert.init_from_pretrained(model, str(tmp_path),
                                         log=lambda *_: None)
    got, want = to_jax(model)['params'], to_jax(pre)['params']
    for k in want:
        src = fresh if k == 'classifier' else want[k]
        assert all(np.array_equal(a, b) for a, b in
                   zip(jax.tree.leaves(got[k]), jax.tree.leaves(src))), k
