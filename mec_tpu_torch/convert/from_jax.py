"""JAX-package parameters -> the port's parameters.

The port reads the numpy trees the JAX package uses (a Flax
{'params', 'batch_stats'} tree of arrays), as convert/store.load_params
reads them from a .mecp file.

Speech: two consumers take the same tree:
  * speech_state_from_jax -> the state dict of models.SpeechDNN (the
    plain model); Flax Dense kernels are (in, out), torch Linear.weight
    is (out, in).
  * ops.speech_kernels.make_speech_dnn -> the folded kernel weights
    (BatchNorm folded into each Dense by fold_batchnorm, flattened).

Image, text and fusion: state_from_jax (named image_state_from_jax,
mobilenet_state_from_jax, bert_state_from_jax and fusion_state_from_jax
at its call sites) -> the state dict of models.resnet.ImageEmotionModel
and models.mobilenet.MobileNetV2EmotionModel (live BN, BN-folded or
int8), models.bert.BertForSequenceClassification (plain or int8) and
models.fusion.MultiModalFusionModel.

Bi-LSTM: lstm_state_from_jax -> models.bilstm.BiLSTMTextModel: each
Flax BiLSTM {forward, backward} pair of KerasLSTMs {kernel (D, 4u),
recurrent_kernel (u, 4u), bias} becomes one bidirectional nn.LSTM
(weight_ih_l0 = kernel.T, weight_hh_l0 = recurrent_kernel.T, bias_ih_l0
= bias, bias_hh_l0 = 0; the backward direction under *_reverse).

Forest: forest_from_jax -> the tables of models.forest.forest_apply.

state_dict_from_jax picks the converter by the module's class, and
convert/to_jax.py inverts all of them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def speech_widths(variables: Dict) -> Tuple[int, ...]:
    """Hidden widths of a speech tree (dense_0 .. dense_{n-1})."""
    p = variables['params']
    n = sum(1 for k in p if k.startswith('bn_'))
    return tuple(int(np.shape(p[f'dense_{i}']['kernel'])[1])
                 for i in range(n))


def speech_state_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """Flax SpeechDNN variables -> models.SpeechDNN state dict."""
    p = variables['params']
    s = variables.get('batch_stats', {})
    state = {}
    for i in range(len(speech_widths(variables))):
        state[f'dense.{i}.weight'] = _t(np.asarray(p[f'dense_{i}']['kernel']).T)
        state[f'dense.{i}.bias'] = _t(p[f'dense_{i}']['bias'])
        state[f'bn.{i}.weight'] = _t(p[f'bn_{i}']['scale'])
        state[f'bn.{i}.bias'] = _t(p[f'bn_{i}']['bias'])
        state[f'bn.{i}.running_mean'] = _t(s[f'bn_{i}']['mean'])
        state[f'bn.{i}.running_var'] = _t(s[f'bn_{i}']['var'])
        state[f'bn.{i}.num_batches_tracked'] = torch.tensor(0)
    state['out.weight'] = _t(np.asarray(p['dense_out']['kernel']).T)
    state['out.bias'] = _t(p['dense_out']['bias'])
    return state


def state_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A Flax {'params'[, 'batch_stats']} tree -> the state dict of the
    port's module with the same names (``layer1_0/conv1`` ->
    ``layer1_0.conv1``). Per node:

      * conv ``{kernel HWIO[, bias]}`` -> ``weight`` OIHW[, ``bias``];
      * Dense ``{kernel (in, out), bias}`` -> ``weight`` (out, in), ``bias``;
      * Embed ``{embedding}`` -> ``weight``;
      * BN ``{scale, bias}`` + batch_stats ``{mean, var}`` -> BatchNorm2d;
        LayerNorm ``{scale, bias}`` (no batch_stats) -> ``weight``, ``bias``;
      * int8 ``{kernel_q, kernel_scale, bias[, act_scale]}`` ->
        QuantConv/QuantDense buffers, ``kernel_q`` as (out, kh*kw*in),
        input channel fastest (a dense kernel: (out, in));
      * a bare array (the fusion MHA's ``in_proj_weight``, already in
        torch's (3e, e) layout, and ``in_proj_bias``; an MoE layer's
        ``wi``, ``wo``, ``bi``, ``bo``, beside its ``router`` Dense) ->
        itself.
    """
    state: Dict[str, torch.Tensor] = {}

    def walk(node, stats, prefix):
        for k, v in node.items():
            name = prefix + k
            if not isinstance(v, dict):
                state[name] = _t(v)
            elif 'kernel_q' in v:
                q = np.asarray(v['kernel_q'], np.int8)
                state[name + '.kernel_q'] = torch.from_numpy(
                    np.ascontiguousarray(q.reshape(-1, q.shape[-1]).T))
                state[name + '.kernel_scale'] = _t(v['kernel_scale'])
                state[name + '.bias'] = _t(v['bias'])
                if 'act_scale' in v:
                    state[name + '.act_scale'] = _t(v['act_scale']).reshape(())
            elif 'kernel' in v:
                K = np.asarray(v['kernel'], np.float32)
                state[name + '.weight'] = _t(
                    K.transpose(3, 2, 0, 1) if K.ndim == 4 else K.T)
                if 'bias' in v:
                    state[name + '.bias'] = _t(v['bias'])
            elif 'embedding' in v:
                state[name + '.weight'] = _t(v['embedding'])
            elif 'scale' in v:
                state[name + '.weight'] = _t(v['scale'])
                state[name + '.bias'] = _t(v['bias'])
                if k in stats:
                    state[name + '.running_mean'] = _t(stats[k]['mean'])
                    state[name + '.running_var'] = _t(stats[k]['var'])
                    state[name + '.num_batches_tracked'] = torch.tensor(0)
            else:
                walk(v, stats.get(k, {}), name + '.')

    walk(variables['params'], variables.get('batch_stats', {}), '')
    return state


# One walk serves every Flax tree the engine loads: ResNet50 (live BN,
# folded or int8) -> models.resnet.ImageEmotionModel, MobileNetV2 (the
# same three forms; a depthwise HWIO kernel (3, 3, 1, C) becomes torch's
# (C, 1, 3, 3)) -> models.mobilenet.MobileNetV2EmotionModel, BERT (plain
# or int8) -> models.bert.BertForSequenceClassification, the fusion net
# -> models.fusion.MultiModalFusionModel.
image_state_from_jax = mobilenet_state_from_jax = bert_state_from_jax = \
    fusion_state_from_jax = state_from_jax


def lstm_state_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """Flax BiLSTMTextModel variables -> models.bilstm.BiLSTMTextModel
    state dict."""
    p = dict(variables['params'])
    state = {}
    for layer in ('bilstm_1', 'bilstm_2'):
        for direction, suffix in (('forward', ''), ('backward', '_reverse')):
            node = p[layer][direction]
            pre = f'{layer}.'
            state[pre + 'weight_ih_l0' + suffix] = _t(
                np.asarray(node['kernel']).T)
            state[pre + 'weight_hh_l0' + suffix] = _t(
                np.asarray(node['recurrent_kernel']).T)
            state[pre + 'bias_ih_l0' + suffix] = _t(node['bias'])
            state[pre + 'bias_hh_l0' + suffix] = torch.zeros(
                np.shape(node['bias']))
        del p[layer]
    state.update(state_from_jax({'params': p}))
    return state


def state_dict_from_jax(model: torch.nn.Module, variables: Dict
                        ) -> Dict[str, torch.Tensor]:
    """The state dict of `model` (any of the port's models) from the
    JAX package's tree of the same architecture."""
    from mec_tpu_torch.models.bilstm import BiLSTMTextModel
    from mec_tpu_torch.models.speech_dnn import SpeechDNN
    if isinstance(model, SpeechDNN):
        return speech_state_from_jax(variables)
    if isinstance(model, BiLSTMTextModel):
        return lstm_state_from_jax(variables)
    return state_from_jax(variables)


def forest_from_jax(arrays: Dict, device='cpu') -> Dict[str, torch.Tensor]:
    """The JAX package's forest arrays (mec_tpu/models/forest.py layout:
    int32 topology, float32 thresholds and leaf distributions) -> the
    tensors of models.forest.forest_apply on `device`: indices int64 for
    torch's gathers, thresholds and probabilities float32 (never cast:
    the thresholds define the walk exactly)."""
    out = {}
    for k in ('feature', 'left', 'right'):
        out[k] = torch.from_numpy(np.asarray(arrays[k], np.int64))
    for k in ('threshold', 'proba'):
        a = np.asarray(arrays[k])
        if a.dtype != np.float32:
            raise ValueError(f'forest {k} is {a.dtype}, expected float32')
        out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return {k: v.to(device) for k, v in out.items()}
