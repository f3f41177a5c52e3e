"""The port's parameters -> JAX-package (Flax) numpy trees.

The inverse of convert/from_jax.py, so that convert/store.save_params
writes the .mecp artifacts the JAX trainers write (the same keys, shapes
and float32 arrays) from a model the port trained:

  * nn.Linear (and models.bert.Dense) ``weight`` (out, in), ``bias`` ->
    ``{kernel (in, out), bias}``;
  * a conv (models.resnet.ConvNHWC) ``weight`` OIHW[, ``bias``] ->
    ``{kernel HWIO[, bias]}``;
  * nn.Embedding ``weight`` -> ``{embedding}``;
  * a BatchNorm ``weight``, ``bias`` -> ``{scale, bias}`` under
    'params', ``running_mean``, ``running_var`` -> ``{mean, var}`` under
    'batch_stats';
  * models.bert.LayerNorm ``weight``, ``bias`` -> ``{scale, bias}``;
  * the fusion MHA's ``in_proj_weight`` and ``in_proj_bias`` -> the same
    bare arrays;
  * models.moe.MoEFFN -> ``{router {kernel, bias}, wi, wo, bi, bo}`` (the
    expert bank's arrays as they are: (E, H, F), (E, F, H), (E, F),
    (E, H));
  * a bidirectional nn.LSTM (models.bilstm.BiLSTM) ->
    ``{forward, backward}`` KerasLSTMs ``{kernel, recurrent_kernel,
    bias = bias_ih + bias_hh}``;
  * models.speech_dnn.SpeechDNN's lists -> ``dense_i``, ``bn_i``,
    ``dense_out``.

to_jax(model) returns {'params'[, 'batch_stats']}: the trees the JAX
trainers save (speech and the image models with batch statistics; the
Bi-LSTM, BERT and the fusion net without). Quantized and BN-folded
forms are serving-only and raise.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from mec_tpu_torch.models.bert import LayerNorm
from mec_tpu_torch.models.fusion import TorchMultiheadAttention
from mec_tpu_torch.models.moe import MoEFFN
from mec_tpu_torch.models.speech_dnn import SpeechDNN


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to('cpu', torch.float32).numpy().copy()


def _lstm(m: nn.LSTM) -> Dict:
    out = {}
    for direction, suffix in (('forward', ''), ('backward', '_reverse')):
        bias = (getattr(m, 'bias_ih_l0' + suffix)
                + getattr(m, 'bias_hh_l0' + suffix))
        out[direction] = {
            'kernel': _np(getattr(m, 'weight_ih_l0' + suffix).T),
            'recurrent_kernel': _np(getattr(m, 'weight_hh_l0' + suffix).T),
            'bias': _np(bias)}
    return out


def _walk(module: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) of module's children, by child name."""
    params: Dict = {}
    stats: Dict = {}
    for name, m in module.named_children():
        if isinstance(m, nn.LSTM):
            params[name] = _lstm(m)
        elif isinstance(m, MoEFFN):
            params[name] = {'router': {'kernel': _np(m.router.weight.T),
                                       'bias': _np(m.router.bias)},
                            'wi': _np(m.wi), 'wo': _np(m.wo),
                            'bi': _np(m.bi), 'bo': _np(m.bo)}
        elif isinstance(m, TorchMultiheadAttention):
            sub, _ = _walk(m)
            params[name] = dict(sub, in_proj_weight=_np(m.in_proj_weight),
                                in_proj_bias=_np(m.in_proj_bias))
        elif isinstance(m, nn.Linear):
            params[name] = {'kernel': _np(m.weight.T), 'bias': _np(m.bias)}
        elif isinstance(m, nn.Conv2d):
            params[name] = {'kernel': _np(m.weight.permute(2, 3, 1, 0))}
            if m.bias is not None:
                params[name]['bias'] = _np(m.bias)
        elif isinstance(m, nn.Embedding):
            params[name] = {'embedding': _np(m.weight)}
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            params[name] = {'scale': _np(m.weight), 'bias': _np(m.bias)}
            stats[name] = {'mean': _np(m.running_mean),
                           'var': _np(m.running_var)}
        elif isinstance(m, LayerNorm):
            params[name] = {'scale': _np(m.weight), 'bias': _np(m.bias)}
        elif any('.' not in k for k in m.state_dict(keep_vars=True)):
            raise TypeError(f'to_jax: no Flax layout for {name} '
                            f'({type(m).__name__})')
        else:
            sub, sub_stats = _walk(m)
            if sub:
                params[name] = sub
            if sub_stats:
                stats[name] = sub_stats
    return params, stats


def to_jax(model: nn.Module) -> Dict[str, Dict]:
    """{'params'[, 'batch_stats']} of `model` in the JAX package's layout."""
    if isinstance(model, SpeechDNN):
        params, stats = {}, {}
        for i, (dense, bn) in enumerate(zip(model.dense, model.bn)):
            params[f'dense_{i}'] = {'kernel': _np(dense.weight.T),
                                    'bias': _np(dense.bias)}
            params[f'bn_{i}'] = {'scale': _np(bn.weight), 'bias': _np(bn.bias)}
            stats[f'bn_{i}'] = {'mean': _np(bn.running_mean),
                                'var': _np(bn.running_var)}
        params['dense_out'] = {'kernel': _np(model.out.weight.T),
                               'bias': _np(model.out.bias)}
    else:
        params, stats = _walk(model)
    variables = {'params': params}
    if stats:
        variables['batch_stats'] = stats
    return variables
