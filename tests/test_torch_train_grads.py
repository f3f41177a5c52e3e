"""One training step of each port model against jax.value_and_grad.

Each case builds the JAX model and the port's on the same numpy-seeded
parameters (the port's through convert/from_jax), runs the trainer's
loss on the same batch with dropout off on both sides (the JAX side's
flax.linen.Dropout monkeypatched to the identity, the port's nn.Dropout
modules at p=0: the two dropout streams cannot match), and compares the
loss, every gradient (the port's through convert/to_jax, so the trees
line up leaf for leaf) and the BatchNorm statistics after the step. The
port's loss and gradients come from the trainer's own train_step, with
an optimizer that records the gradients it is handed.

Tolerances, fp32 on the CPU, each relative to the largest magnitude of
its tree (measured worst in brackets):

* loss: 1e-5 relative (measured <= 1e-6);
* gradients: 2e-4 of the tree's largest gradient (measured 4.1e-5,
  MobileNetV2; ResNet50 5.8e-6; the others <= 4e-7): summation orders
  of the convolutions' and matmuls' backward passes differ;
* BatchNorm statistics: 5e-5 of the largest statistic (measured
  1.2e-5, MobileNetV2, where Flax's fp32 E[x^2] - E[x]^2, which the
  port keeps, loses digits against the float64 reference; the others
  <= 6e-7).

For the two image models the JAX reference is computed in float64 (the
Flax model with dtype float64 under jax.enable_x64; the port stays
fp32): XLA's own fp32 gradient of ResNet50 here is up to 7.4e-2 of the
largest gradient away from its float64 one in layer1_0 (measured; the
port's fp32 gradient is 1.2e-6 from float64 there), so fp32 JAX is no
reference for it at any useful tolerance.

ResNet50 is the torchvision graph with one bottleneck a stage
(stage_sizes (1, 1, 1, 1)), which keeps the stem, the four
downsampling blocks and the head; MobileNetV2 is whole. Both take B=2
at 64 px: at 32 px the last stage is 1x1, so its BatchNorms see two
values a channel, and Flax's E[x^2] - E[x]^2 variance of two nearly
equal values is rounding noise that rsqrt amplifies (measured: logits
0.55 apart at 32 px, 6e-5 at 64 px, on the same parameters).
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mec_tpu.image.preprocess import IMAGENET_MEAN, IMAGENET_STD
from mec_tpu.models.bert import BertForSequenceClassification as JaxBert
from mec_tpu.models.bilstm import BiLSTMTextModel as JaxLSTM
from mec_tpu.models.fusion import MultiModalFusionModel as JaxFusion
from mec_tpu.models.mobilenet import MobileNetV2EmotionModel as JaxMobile
from mec_tpu.models.resnet import ImageEmotionModel as JaxResNet
from mec_tpu.models.speech_dnn import SpeechDNN as JaxSpeech
from mec_tpu.training.train_speech import l2_penalty as jax_l2
from mec_tpu_torch.convert.from_jax import state_dict_from_jax
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.models.bilstm import BiLSTMTextModel
from mec_tpu_torch.models.fusion import MultiModalFusionModel
from mec_tpu_torch.models.mobilenet import MobileNetV2EmotionModel
from mec_tpu_torch.models.resnet import ImageEmotionModel
from mec_tpu_torch.models.speech_dnn import SpeechDNN
from mec_tpu_torch.training import (common, train_fusion, train_image,
                                    train_speech, train_text_bert,
                                    train_text_lstm)


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


LOSS_RTOL, GRAD_RTOL, STATS_RTOL = 1e-5, 2e-4, 5e-5


class Record(common.Tx):
    """An optimizer that keeps the gradients and changes nothing."""

    def __init__(self):
        super().__init__({'all': None})
        self.grads = None

    def step(self, grads, state, params, norm_fn=None):
        self.grads = [g.detach().clone() for g in grads]


def _onehot(labels, n=7):
    return np.eye(n, dtype=np.float32)[labels]


def _jnorm(img, dtype):
    return (jnp.asarray(img, dtype) / 255.0 - IMAGENET_MEAN.astype(dtype)) \
        / IMAGENET_STD.astype(dtype)


def speech_case(rng):
    x = rng.randn(6, 56).astype(np.float32)
    labels = np.arange(6) % 7
    jm = JaxSpeech(widths=(16, 8), dropout_rates=(0.4, 0.3))

    def loss(params, bs):
        (p, _), mut = jm.apply({'params': params, 'batch_stats': bs}, x,
                               train=True, mutable=['batch_stats'])
        ce = -(_onehot(labels) * jnp.log(jnp.clip(p, 1e-12, 1.0))
               ).sum(-1).mean()
        return ce + jax_l2(params), mut['batch_stats']

    port = SpeechDNN(widths=(16, 8), dropout_rates=(0.4, 0.3))
    return (jm, (jnp.zeros((1, 56)),), loss, port, train_speech.make_steps,
            {'x': x, 'label': _onehot(labels)})


def lstm_case(rng):
    ids = rng.randint(0, 50, (4, 10)).astype(np.int32)
    ids[:, 7:] = 0
    labels = np.array([0, 3, 6, 2])
    kw = dict(vocab_size=50, embed_dim=8, lstm_units=(8, 4),
              dense_units=(8, 4))
    jm = JaxLSTM(**kw)

    def loss(params, bs):
        probs, _ = jm.apply({'params': params}, ids, train=True)
        return -(_onehot(labels) * jnp.log(jnp.clip(probs, 1e-12, 1.0))
                 ).sum(-1).mean(), bs

    return (jm, (jnp.asarray(ids),), loss, BiLSTMTextModel(**kw),
            train_text_lstm.make_steps, {'ids': ids, 'label': labels})


def bert_case(rng):
    kw = dict(vocab_size=50, hidden_size=32, num_layers=2, num_heads=2,
              intermediate_size=64)
    ids = rng.randint(5, 50, (4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = mask[3, 4:] = 0
    ids[mask == 0] = 0
    labels = np.array([1, 4, 0, 5])
    jm = JaxBert(**kw, dropout_rate=0.0)

    def loss(params, bs):
        logits, _ = jm.apply({'params': params}, ids, mask, train=True)
        logp = jax.nn.log_softmax(logits, -1)
        return -(_onehot(labels) * logp).sum(-1).mean(), bs

    return (jm, (jnp.asarray(ids), jnp.asarray(mask)), loss,
            BertForSequenceClassification(**kw, dropout_rate=0.0),
            train_text_bert.make_steps,
            {'ids': ids, 'mask': mask, 'label': labels})


def image_case(jax_cls, port_cls, kw):
    def case(rng):
        img = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
        labels = np.array([2, 5])
        jm = jax_cls(**kw, dtype=jnp.float64)

        def loss(params, bs):
            (logits, _), mut = jm.apply(
                {'params': params, 'batch_stats': bs},
                _jnorm(img, jnp.float64), train=True,
                mutable=['batch_stats'])
            logp = jax.nn.log_softmax(logits, -1)
            return -(_onehot(labels) * logp).sum(-1).mean(), \
                mut['batch_stats']

        return (jm, (jnp.zeros((1, 64, 64, 3)),), loss, port_cls(**kw),
                train_image.make_steps, {'img': img, 'label': labels})
    return case


def fusion_case(rng):
    kw = dict(speech_dim=8, text_dim=12, image_dim=10, hidden_dim=16)
    feats = [rng.randn(5, d).astype(np.float32) for d in (8, 12, 10)]
    preds = [rng.dirichlet(np.ones(7), 5).astype(np.float32)
             for _ in range(3)]
    labels = np.array([0, 1, 2, 3, 6])
    jm = JaxFusion(**kw)

    def loss(params, bs):
        logits, _aw, _dw = jm.apply({'params': params}, *feats, *preds,
                                    train=True)
        logp = jax.nn.log_softmax(logits, -1)
        return -(_onehot(labels) * logp).sum(-1).mean(), bs

    batch = dict(zip(('s_feat', 't_feat', 'i_feat', 's_pred', 't_pred',
                      'i_pred'), feats + preds), label=labels)
    return (jm, [jnp.zeros((1, a.shape[1])) for a in feats + preds], loss,
            MultiModalFusionModel(**kw), train_fusion.make_steps, batch)


CASES = {
    'speech': speech_case,
    'bilstm': lstm_case,
    'bert': bert_case,
    'mobilenet_v2': image_case(JaxMobile, MobileNetV2EmotionModel, {}),
    'resnet50': image_case(JaxResNet, ImageEmotionModel,
                           {'stage_sizes': (1, 1, 1, 1)}),
    'fusion': fusion_case,
}


def _close(got, want, rtol, what):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    scale = max(float(np.abs(w).max()) for w in want)
    worst = max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
                for g, w in zip(got, want))
    print(f'{what}: worst {worst:.3e} of scale {scale:.3e} '
          f'({worst / scale:.2e})')
    assert worst <= rtol * scale, (what, worst, scale)


@pytest.mark.parametrize('name', list(CASES))
def test_one_step_matches_jax_value_and_grad(name, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, '__call__',
                        lambda self, inputs, *a, **k: inputs)
    jm, init_args, jax_loss, port, make_steps, batch = \
        CASES[name](np.random.RandomState(0))
    variables = jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jm.init(jax.random.PRNGKey(1), *init_args))
    x64 = getattr(jm, 'dtype', None) == jnp.float64
    with jax.enable_x64(x64):
        wide = jax.tree.map(lambda a: a.astype(np.float64) if x64 else a,
                            variables)
        (want_loss, want_bs), want_grads = jax.jit(jax.value_and_grad(
            jax_loss, has_aux=True))(wide['params'],
                                     wide.get('batch_stats', {}))
        want_loss, want_bs, want_grads = jax.tree.map(
            np.asarray, (want_loss, want_bs, want_grads))

    port.load_state_dict(state_dict_from_jax(port, variables))
    port.apply(lambda m: setattr(m, 'p', 0.0)
               if isinstance(m, nn.Dropout) else None)
    port.train()
    tx = Record()
    state = common.TrainState(port, tx)
    train_step, _eval = make_steps(port)
    loss = train_step(state, common.to_device(batch, 'cpu'))

    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    grads = copy.deepcopy(port)
    with torch.no_grad():
        for p in grads.parameters():
            p.zero_()
        named = dict(grads.named_parameters())
        for n, g in zip(state.names, tx.grads):
            named[n].copy_(g)
    _close(to_jax(grads)['params'], want_grads, GRAD_RTOL,
           f'{name} gradients')
    if want_bs:
        _close(to_jax(port)['batch_stats'], want_bs, STATS_RTOL,
               f'{name} batch statistics')
