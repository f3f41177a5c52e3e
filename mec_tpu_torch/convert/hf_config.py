"""The BERT widths from a HuggingFace config.json.

A copy of read_config and model_kwargs_from_config of
mec_tpu/convert/hf_bert.py (importing mec_tpu imports jax), the
mixture-of-experts fields included (num_experts, moe_capacity_factor:
absent from every HF config, written by train-text-bert --experts).
tests/test_torch_models_dir.py pins the copy to the original.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict


def read_config(model_dir: str) -> Dict[str, Any]:
    with open(os.path.join(model_dir, 'config.json')) as f:
        return json.load(f)


def model_kwargs_from_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    return dict(
        vocab_size=cfg.get('vocab_size', 30522),
        hidden_size=cfg.get('hidden_size', 768),
        num_layers=cfg.get('num_hidden_layers', 12),
        num_heads=cfg.get('num_attention_heads', 12),
        intermediate_size=cfg.get('intermediate_size', 3072),
        max_position=cfg.get('max_position_embeddings', 512),
        type_vocab_size=cfg.get('type_vocab_size', 2),
        num_classes=cfg.get('num_labels',
                            len(cfg.get('id2label', {})) or 7),
        **({'num_experts': cfg['num_experts'],
            'moe_capacity_factor': cfg.get('moe_capacity_factor', 1.25)}
           if cfg.get('num_experts') else {}),
    )
