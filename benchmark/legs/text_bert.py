"""BERT-base for sequence classification, the port's `bert_variables`
tree (Flax layout), drawn from the run's trees.Draws."""

from __future__ import annotations

from typing import Dict

import numpy as np

from benchmark.weights.trees import Draws

# the tiny copy's widths: 2 layers of width 64 over the full vocabulary
TINY = {'vocab_size': 30522, 'hidden_size': 64, 'num_hidden_layers': 2,
        'num_attention_heads': 2, 'intermediate_size': 128,
        'max_position_embeddings': 128}


def _zeros(*shape):
    return np.zeros(shape, np.float32)


def plan(d: Draws, vocab_size: int = 30522, hidden_size: int = 768,
         num_hidden_layers: int = 12, intermediate_size: int = 3072,
         max_position_embeddings: int = 512, type_vocab_size: int = 2,
         num_labels: int = 7, **_ignored) -> Dict:
    """BERT's own init (N(0, 0.02) embeddings and kernels, zero biases,
    LayerNorm scale 1); the pooler at lecun scale, the classifier at 8x
    lecun scale (columns centred after the draw)."""
    h, f = hidden_size, intermediate_size

    def dense(din, dout):
        return {'kernel': d.normal(din, dout, std=0.02),
                'bias': _zeros(dout)}

    def norm(n):
        return {'scale': np.ones(n, np.float32), 'bias': _zeros(n)}

    params = {'word_embeddings': {'embedding': d.normal(vocab_size, h,
                                                        std=0.02)},
              'position_embeddings': {'embedding': d.normal(
                  max_position_embeddings, h, std=0.02)},
              'token_type_embeddings': {'embedding': d.normal(
                  type_vocab_size, h, std=0.02)},
              'embeddings_norm': norm(h)}
    for i in range(num_hidden_layers):
        params[f'layer_{i}'] = {
            'attention_self': {n: dense(h, h)
                               for n in ('query', 'key', 'value')},
            'attention_output': dense(h, h),
            'attention_norm': norm(h),
            'intermediate': dense(h, f),
            'output': dense(f, h),
            'output_norm': norm(h)}
    params['pooler'] = {'kernel': d.normal(h, h, std=1 / np.sqrt(h)),
                        'bias': _zeros(h)}
    params['classifier'] = {'kernel': d.normal(h, num_labels,
                                               std=8 / np.sqrt(h)),
                            'bias': _zeros(num_labels)}
    return {'params': params}


def post(tree: Dict) -> None:
    """The special tokens' rows (ids 0-4), position 0 and token type 0
    are zero, so [CLS] is made by attention over the text; the
    classifier's columns are centred."""
    p = tree['params']
    p['word_embeddings']['embedding'][:5] = 0.0
    p['position_embeddings']['embedding'][0] = 0.0
    p['token_type_embeddings']['embedding'][0] = 0.0
    k = p['classifier']['kernel']
    k -= k.mean(axis=0)


def engine_kwargs(text: Dict, tree: Dict, vocab) -> Dict:
    """EmotionEngine's BERT keywords."""
    return dict(bert_variables=tree,
                bert_kwargs=dict(vocab_size=text['vocab_size'],
                                 hidden_size=text['hidden_size'],
                                 num_layers=text['num_hidden_layers'],
                                 num_heads=text['num_attention_heads'],
                                 intermediate_size=text['intermediate_size'],
                                 max_position=text['max_position_embeddings'],
                                 type_vocab_size=text['type_vocab_size'],
                                 num_classes=text['num_labels']),
                bert_vocab=vocab)
