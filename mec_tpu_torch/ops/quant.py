"""Int8 post-training quantization for the serving image and BERT paths.

The port of mec_tpu/ops/quant.py. The tree functions (quantize_conv,
quantize_image_params, quantize_bert_params, extract_static_scales,
insert_static_scales) are numpy copies of the original's; the one
change is the kernel_q count in quantize_image_params, a numpy walk
here where the original walks jax.tree_util paths.
calibrate_static_scales runs the port's dynamic-mode model
(models/qconv.QuantConv and QuantDense record each layer's observed
max-abs where the Flax modules sow it) and inserts the same act_scale
values. tests/test_torch_image.py and tests/test_torch_text.py pin each
against the original.

Scheme (standard PTQ):

- **Weights**: symmetric per-output-channel int8 from the BN-folded
  conv kernels (ops/fold.fold_conv_bn runs first):
  ``kernel_q = round(K / s_c)`` with ``s_c = max|K[..., c]| / 127``.
- **Activations**: symmetric int8, either per example on the device
  (max-abs over H, W, C; 'dynamic') or one calibrated scalar per conv
  ('static', the serving default).
- **Dequant**: ``acc * (s_x * s_c) + bias`` in f32, then the compute
  dtype.

The stem conv and the head stay in the compute dtype (three input
channels; negligible FLOPs). In BERT the six encoder matmuls of every
layer are quantized; embeddings, LayerNorms, the attention score and
context products, the pooler and the classifier stay in the compute
dtype. A mixture-of-experts layer ('moe' in place of 'intermediate'
and 'output') keeps its expert bank in the compute dtype: only its four
attention matmuls quantize, so its static scales carry the JAX engine's
keys (layer_i/attention_self/query ... layer_i/attention_output).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mec_tpu_torch.models.qconv import QuantConv, QuantDense

# top-level modules never quantized: the stem conv and the classifier
# head. Nested bottleneck convs (layer*_*/conv1 etc.) are matched by the
# recursion, not these names.
_SKIP_TOP = ('conv1', 'conv_stem', 'fc1', 'fc2')


def quantize_conv(node: Dict) -> Dict:
    """One biased kernel node ``{'kernel': f32 [..., c], 'bias': f32[c]}``
    -> ``{'kernel_q': s8, 'kernel_scale': f32[c], 'bias': f32[c]}``
    (per-output-channel scale = per last axis)."""
    K = np.asarray(node['kernel'], np.float32)
    s = np.abs(K).reshape(-1, K.shape[-1]).max(axis=0) / 127.0
    s = np.maximum(s, 1e-12)  # all-zero channel: quantizes to zeros
    kq = np.clip(np.round(K / s), -127, 127).astype(np.int8)
    return {'kernel_q': kq, 'kernel_scale': s.astype(np.float32),
            'bias': np.asarray(node['bias'], np.float32)}


def _is_folded_conv(name: str, val) -> bool:
    if not ('conv' in name and isinstance(val, dict) and 'kernel' in val
            and 'bias' in val and np.ndim(val['kernel']) == 4):
        return False
    # depthwise convs (HWIO in-per-group == 1) stay in compute_dtype
    return np.shape(val['kernel'])[-2] != 1


def _quantize_node(node: Dict, top: bool) -> Dict:
    out = {}
    for name, val in node.items():
        if top and name in _SKIP_TOP:
            out[name] = val
        elif _is_folded_conv(name, val):
            out[name] = quantize_conv(val)
        elif isinstance(val, dict) and 'kernel' not in val \
                and 'embedding' not in val:
            out[name] = _quantize_node(val, top=False)
        else:
            out[name] = val
    return out


def _count_key(tree, key: str) -> int:
    if not isinstance(tree, dict):
        return 0
    return sum((k == key and not isinstance(v, dict)) + _count_key(v, key)
               for k, v in tree.items())


def quantize_image_params(variables: Dict) -> Dict:
    """BN-folded ``{'params': ...}`` -> int8-quantized params tree.

    Raises if the tree carries live batch_stats (fold first) or if no
    conv was quantized (wrong tree)."""
    if variables.get('batch_stats'):
        raise ValueError('quantize_image_params expects a BN-folded tree '
                         '(run ops/fold.fold_conv_bn first)')
    params = _quantize_node(variables['params'], top=True)
    if _count_key(params, 'kernel_q') == 0:
        raise ValueError('quantize_image_params: no folded convs found')
    return {'params': params}


_BERT_ATTN_DENSE = ('query', 'key', 'value')
_BERT_LAYER_DENSE = ('attention_output', 'intermediate', 'output')


def quantize_bert_params(variables: Dict) -> Dict:
    """BERT params -> the encoder Dense layers of every ``layer_*``
    quantized to int8 (models/qconv.QuantDense consumes them). Raises if
    the tree has no encoder layers."""
    params = dict(variables['params'])
    n_q = 0
    for lname, lval in params.items():
        if not lname.startswith('layer_'):
            continue
        new = {}
        for name, val in lval.items():
            if name in _BERT_LAYER_DENSE and 'kernel' in val:
                new[name] = quantize_conv(val)
                n_q += 1
            elif name == 'attention_self':
                new[name] = {
                    k: (quantize_conv(v) if k in _BERT_ATTN_DENSE else v)
                    for k, v in val.items()}
                n_q += len(_BERT_ATTN_DENSE)
            else:
                new[name] = val
        params[lname] = new
    if n_q == 0:
        raise ValueError('quantize_bert_params: no encoder layers found')
    return dict(variables, params=params)


# incremented by every calibrate_static_scales run; tests assert it stays
# flat when the scales come from image_meta['int8_scales']
CALIBRATION_RUNS = 0


@torch.no_grad()
def calibrate_static_scales(model_dynamic: torch.nn.Module,
                            variables: Dict, inputs,
                            margin: float = 1.25) -> Dict:
    """Static-PTQ calibration: one forward of the DYNAMIC-mode model on
    representative inputs (a tensor, or a tuple of the model's
    arguments; each QuantConv/QuantDense records its observed
    activation max-abs in ``act_amax``), then every quantized layer of
    ``variables`` gets a scalar ``act_scale`` = ``margin * amax / 127``.
    Module paths map to tree paths by their names (``layer1_0.conv1``
    -> ``layer1_0/conv1``). Returns the new tree."""
    global CALIBRATION_RUNS
    CALIBRATION_RUNS += 1
    convs = {name.replace('.', '/'): m
             for name, m in model_dynamic.named_modules()
             if isinstance(m, (QuantConv, QuantDense))}
    if not convs or any(m.mode != 'dynamic' for m in convs.values()):
        raise ValueError('calibrate_static_scales needs a dynamic-mode '
                         'quantized model')
    for m in convs.values():
        m.act_amax = None
    model_dynamic(*(inputs if isinstance(inputs, tuple) else (inputs,)))

    def insert(node, prefix):
        new = {}
        for k, v in node.items():
            if isinstance(v, dict) and 'kernel_q' in v:
                m = convs.get(prefix + k)
                if m is None or m.act_amax is None:
                    raise ValueError(f'no calibration trace for {k}')
                a = float(m.act_amax)
                new[k] = dict(v, act_scale=np.float32(
                    max(a * margin, 1e-8) / 127.0))
            elif isinstance(v, dict):
                new[k] = insert(v, prefix + k + '/')
            else:
                new[k] = v
        return new

    return dict(variables, params=insert(variables['params'], ''))


def extract_static_scales(calibrated: Dict) -> Dict[str, float]:
    """Calibrated params tree -> flat ``{'a/b/c': act_scale}`` dict (the
    key format of the JAX package's .mecp scale cache)."""
    out: Dict[str, float] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict) and 'act_scale' in v:
                out[prefix + k] = float(np.asarray(v['act_scale']))
            elif isinstance(v, dict):
                walk(v, prefix + k + '/')
    walk(calibrated['params'], '')
    if not out:
        raise ValueError('no act_scale params found (not a static-'
                         'calibrated tree)')
    return out


def insert_static_scales(variables: Dict, scales: Dict[str, float]) -> Dict:
    """Inverse of extract_static_scales: place cached ``act_scale``
    scalars next to every quantized (``kernel_q``) node. Raises if any
    quantized layer has no cached scale (the cache is stale)."""
    missing = []

    def walk(node, prefix):
        new = {}
        for k, v in node.items():
            if isinstance(v, dict) and 'kernel_q' in v:
                s = scales.get(prefix + k)
                if s is None:
                    missing.append(prefix + k)
                    new[k] = v
                else:
                    new[k] = dict(v, act_scale=np.float32(s))
            elif isinstance(v, dict):
                new[k] = walk(v, prefix + k + '/')
            else:
                new[k] = v
        return new

    params = walk(variables['params'], '')
    if missing:
        raise ValueError(f'cached scales missing for {missing[:3]}'
                         f'{"..." if len(missing) > 3 else ""}')
    return dict(variables, params=params)
