"""torch .pt state-dict -> Flax-layout trees (image and fusion models).

A copy of mec_tpu/convert/torch_pt.py (importing mec_tpu imports jax):
the same functions and trees, with INVERTED_RESIDUAL_CFG from the port's
models/mobilenet.py. The port's engine then maps these trees onto its
modules (convert/from_jax.py), as it does for a .mecp.

Layout rules:
  * Linear weight (out, in) -> Flax Dense kernel (in, out): transpose.
  * Conv2d weight OIHW -> Flax Conv HWIO: transpose (2, 3, 1, 0).
  * BatchNorm weight/bias -> scale/bias; running_mean/var -> batch_stats.
  * nn.MultiheadAttention packed in_proj_weight/bias stay in torch
    layout; out_proj is a Linear.

Checkpoint layouts follow what the reference trainers emit:
  * models/image_model.pt — plain state_dict of ImageEmotionModel
    (reference model_training/train_image_model.py:209-214)
  * models/fusion_model.pt — {'model_state_dict': ..., 'config': {dims}}
    (reference model_training/train_fusion_model.py:605-619)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from mec_tpu_torch.models.mobilenet import INVERTED_RESIDUAL_CFG


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    obj = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(obj, dict) and 'model_state_dict' in obj:
        sd = obj['model_state_dict']
    elif isinstance(obj, dict) and 'state_dict' in obj:
        sd = obj['state_dict']
    else:
        sd = obj
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _linear(sd, prefix):
    return {'kernel': sd[f'{prefix}.weight'].T, 'bias': sd[f'{prefix}.bias']}


def _layernorm(sd, prefix):
    return {'scale': sd[f'{prefix}.weight'], 'bias': sd[f'{prefix}.bias']}


def _conv(sd, prefix):
    return {'kernel': sd[f'{prefix}.weight'].transpose(2, 3, 1, 0)}


def _bn(sd, prefix):
    return ({'scale': sd[f'{prefix}.weight'], 'bias': sd[f'{prefix}.bias']},
            {'mean': sd[f'{prefix}.running_mean'],
             'var': sd[f'{prefix}.running_var']})


def convert_image_pt(path_or_sd) -> Dict[str, Any]:
    """image_model.pt -> {'params', 'batch_stats'}.

    Auto-detects the architecture from the state-dict layout: torchvision
    MobileNetV2 keys (base.features.N...) route to the MobileNetV2
    converter (the README-advertised image variant), anything else is the
    reference code's ResNet50 (reference inference/image_inference.py:48-92).
    """
    sd = (_load_state_dict(path_or_sd) if isinstance(path_or_sd, str)
          else path_or_sd)
    if 'base.features.0.0.weight' in sd:
        return convert_image_mobilenet_pt(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params['conv1'] = _conv(sd, 'base.conv1')
    params['bn1'], stats['bn1'] = _bn(sd, 'base.bn1')

    stage_sizes = (3, 4, 6, 3)
    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            t = f'base.layer{stage + 1}.{block}'
            name = f'layer{stage + 1}_{block}'
            p: Dict[str, Any] = {}
            s: Dict[str, Any] = {}
            for i in (1, 2, 3):
                p[f'conv{i}'] = _conv(sd, f'{t}.conv{i}')
                p[f'bn{i}'], s[f'bn{i}'] = _bn(sd, f'{t}.bn{i}')
            if f'{t}.downsample.0.weight' in sd:
                p['downsample_conv'] = _conv(sd, f'{t}.downsample.0')
                p['downsample_bn'], s['downsample_bn'] = _bn(
                    sd, f'{t}.downsample.1')
            params[name] = p
            stats[name] = s

    # custom head: base.fc = Sequential(Dropout, Linear, ReLU, Dropout, Linear)
    params['fc1'] = _linear(sd, 'base.fc.1')
    params['fc2'] = _linear(sd, 'base.fc.4')
    return {'params': params, 'batch_stats': stats}


def convert_image_mobilenet_pt(path_or_sd) -> Dict[str, Any]:
    """MobileNetV2 image_model.pt -> {'params', 'batch_stats'} for
    MobileNetV2EmotionModel (torchvision key layout: features.0 stem CNA,
    features.1-17 InvertedResidual conv.N, features.18 head CNA; custom
    emotion head at classifier.{1,4})."""
    sd = (_load_state_dict(path_or_sd) if isinstance(path_or_sd, str)
          else path_or_sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    params['conv_stem'] = _conv(sd, 'base.features.0.0')
    params['bn_stem'], stats['bn_stem'] = _bn(sd, 'base.features.0.1')

    idx = 1
    for t, _c, n, _s in INVERTED_RESIDUAL_CFG:
        for _ in range(n):
            pre = f'base.features.{idx}.conv'
            p: Dict[str, Any] = {}
            s: Dict[str, Any] = {}
            j = 0
            if t != 1:
                p['expand_conv'] = _conv(sd, f'{pre}.0.0')
                p['expand_bn'], s['expand_bn'] = _bn(sd, f'{pre}.0.1')
                j = 1
            p['dw_conv'] = _conv(sd, f'{pre}.{j}.0')
            p['dw_bn'], s['dw_bn'] = _bn(sd, f'{pre}.{j}.1')
            p['project_conv'] = _conv(sd, f'{pre}.{j + 1}')
            p['project_bn'], s['project_bn'] = _bn(sd, f'{pre}.{j + 2}')
            params[f'block_{idx}'] = p
            stats[f'block_{idx}'] = s
            idx += 1

    params['conv_head'] = _conv(sd, f'base.features.{idx}.0')
    params['bn_head'], stats['bn_head'] = _bn(sd, f'base.features.{idx}.1')
    params['fc1'] = _linear(sd, 'base.classifier.1')
    params['fc2'] = _linear(sd, 'base.classifier.4')
    return {'params': params, 'batch_stats': stats}


def _mha(sd, prefix):
    return {'in_proj_weight': sd[f'{prefix}.in_proj_weight'],
            'in_proj_bias': sd[f'{prefix}.in_proj_bias'],
            'out_proj': _linear(sd, f'{prefix}.out_proj')}


def _projection(sd, prefix):
    return {'linear': _linear(sd, f'{prefix}.0'),
            'norm': _layernorm(sd, f'{prefix}.1')}


def convert_fusion_pt(path_or_sd) -> Dict[str, Any]:
    """fusion_model.pt -> {'params'} for MultiModalFusionModel."""
    sd = (_load_state_dict(path_or_sd) if isinstance(path_or_sd, str)
          else path_or_sd)
    params: Dict[str, Any] = {}
    for mod in ('speech', 'text', 'image'):
        params[f'{mod}_proj'] = _projection(sd, f'{mod}_proj')
        params[f'cross_attn_{mod}'] = {
            'attention': _mha(sd, f'cross_attn_{mod}.attention'),
            'norm': _layernorm(sd, f'cross_attn_{mod}.norm'),
        }
    af: Dict[str, Any] = {}
    for i in range(3):
        af[f'proj_{i}'] = _projection(sd, f'attention_fusion.projections.{i}')
    af['attn_0'] = _linear(sd, 'attention_fusion.attention.0')
    af['attn_1'] = _linear(sd, 'attention_fusion.attention.2')
    params['attention_fusion'] = af
    params['decision_0'] = _linear(sd, 'decision_weights.0')
    params['decision_1'] = _linear(sd, 'decision_weights.2')
    params['classifier_0'] = _linear(sd, 'classifier.0')
    params['classifier_norm'] = _layernorm(sd, 'classifier.1')
    params['classifier_1'] = _linear(sd, 'classifier.4')
    params['classifier_2'] = _linear(sd, 'classifier.7')
    return {'params': params}


def fusion_config_from_pt(path: str) -> Dict[str, int]:
    obj = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(obj, dict) and 'config' in obj:
        return dict(obj['config'])
    return {'speech_dim': 64, 'text_dim': 768, 'image_dim': 512,
            'num_classes': 7, 'hidden_dim': 256}
