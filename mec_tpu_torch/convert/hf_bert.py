"""HuggingFace BERT save_pretrained dir -> the Flax-layout tree of
BertForSequenceClassification.

A copy of mec_tpu/convert/hf_bert.py (importing mec_tpu imports jax);
read_config and model_kwargs_from_config are the port's copies in
convert/hf_config.py, re-exported here under the JAX module's names.
The reference saves its fine-tuned model with save_pretrained
(reference model_training/train_text_model.py:217-223) and loads it with
BertForSequenceClassification.from_pretrained
(reference inference/text_inference.py:40-43). This converter reads the
torch weights (model.safetensors through the safetensors package, else
pytorch_model.bin through torch.load) plus config.json.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from mec_tpu_torch.convert._imports import require
from mec_tpu_torch.convert.hf_config import (  # noqa: F401  (JAX's names)
    model_kwargs_from_config, read_config)


def _read_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    st_path = os.path.join(model_dir, 'model.safetensors')
    bin_path = os.path.join(model_dir, 'pytorch_model.bin')
    if os.path.exists(st_path):
        safe_open = require('safetensors', f'reading {st_path}').safe_open
        sd = {}
        with safe_open(st_path, framework='np') as f:
            for k in f.keys():
                sd[k] = f.get_tensor(k)
        return sd
    obj = torch.load(bin_path, map_location='cpu', weights_only=False)
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def convert_bert_dir(model_dir: str) -> Dict[str, Any]:
    sd = _read_state_dict(model_dir)

    def g(key):
        # BertForSequenceClassification exports prefix encoder keys with
        # "bert."; bare BertModel exports do not — accept both
        if key in sd:
            return np.asarray(sd[key])
        if key.startswith('bert.') and key[5:] in sd:
            return np.asarray(sd[key[5:]])
        return np.asarray(sd[key])  # raise the original KeyError

    def lin(prefix):
        return {'kernel': g(f'{prefix}.weight').T, 'bias': g(f'{prefix}.bias')}

    def ln(prefix):
        return {'scale': g(f'{prefix}.weight'), 'bias': g(f'{prefix}.bias')}

    cfg = read_config(model_dir) if os.path.exists(
        os.path.join(model_dir, 'config.json')) else {}
    n_layers = cfg.get('num_hidden_layers', 12)

    params: Dict[str, Any] = {
        'word_embeddings': {'embedding': g('bert.embeddings.word_embeddings.weight')},
        'position_embeddings': {'embedding': g('bert.embeddings.position_embeddings.weight')},
        'token_type_embeddings': {'embedding': g('bert.embeddings.token_type_embeddings.weight')},
        'embeddings_norm': ln('bert.embeddings.LayerNorm'),
        'pooler': lin('bert.pooler.dense'),
        'classifier': lin('classifier'),
    }
    for i in range(n_layers):
        t = f'bert.encoder.layer.{i}'
        params[f'layer_{i}'] = {
            'attention_self': {
                'query': lin(f'{t}.attention.self.query'),
                'key': lin(f'{t}.attention.self.key'),
                'value': lin(f'{t}.attention.self.value'),
            },
            'attention_output': lin(f'{t}.attention.output.dense'),
            'attention_norm': ln(f'{t}.attention.output.LayerNorm'),
            'intermediate': lin(f'{t}.intermediate.dense'),
            'output': lin(f'{t}.output.dense'),
            'output_norm': ln(f'{t}.output.LayerNorm'),
        }
    return {'params': params}
