"""BERT-base for sequence classification (HF BertForSequenceClassification
at inference): word + position + token-type-0 embeddings, LayerNorm
(eps 1e-12); post-LN layers (their number and heads from the
configuration's text table: 12 and 12 in BERT-base) of attention
(scores / sqrt(64), the additive mask (1 - mask) * float32 min, softmax)
and an erf-GELU FFN;
the tanh pooler on [CLS] and the classifier. Returns (probs, the [CLS]
last hidden state, the fusion's text feature).

Stages: the six encoder matmuls of a layer are 'text_int8' (the program
runs them in int8), the attention products, embeddings' sum, pooler and
classifier 'text_bf16'."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.weights.seeded import materialize


def _ln(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p['scale'] + p['bias']


def _layer(h, lp, bias, heads: int, prec):
    B, L, _ = h.shape
    a = lp['attention_self']

    def heads_of(t):
        return t.reshape(B, L, heads, -1).transpose(1, 2)

    q, k, v = (heads_of(prec.linear(h, a[n]['kernel'], a[n]['bias'],
                                    'text_int8'))
               for n in ('query', 'key', 'value'))
    scores = prec.matmul(q, k.transpose(-1, -2), 'text_bf16') \
        / math.sqrt(q.shape[-1])
    probs = torch.softmax(scores + bias[:, None, None, :], -1)
    ctx = prec.matmul(probs, v, 'text_bf16').transpose(1, 2) \
        .reshape(B, L, -1)
    o = lp['attention_output']
    h = _ln(h + prec.linear(ctx, o['kernel'], o['bias'], 'text_int8'),
            lp['attention_norm'], 1e-12)
    inter = F.gelu(prec.linear(h, lp['intermediate']['kernel'],
                               lp['intermediate']['bias'], 'text_int8'))
    out = prec.linear(inter, lp['output']['kernel'],
                      lp['output']['bias'], 'text_int8')
    return _ln(h + out, lp['output_norm'], 1e-12)


def forward(tree, ids: torch.Tensor, mask: torch.Tensor, text, prec):
    """text: the configuration's text table. Seeded leaves
    (benchmark/weights/seeded.py) are drawn where they are used, a layer
    at a time, and dropped with it."""
    p = tree['params']
    L = ids.shape[1]
    e = materialize({k: p[k] for k in (
        'word_embeddings', 'position_embeddings', 'token_type_embeddings',
        'embeddings_norm')})
    h = (e['word_embeddings']['embedding'][ids]
         + e['position_embeddings']['embedding'][:L][None]
         + e['token_type_embeddings']['embedding'][0])
    h = _ln(prec.values(h, 'text_bf16'), e['embeddings_norm'], 1e-12)
    del e
    bias = (1.0 - mask.float()) * torch.finfo(torch.float32).min
    for i in range(text['num_hidden_layers']):
        h = _layer(h, materialize(p[f'layer_{i}']), bias,
                   text['num_attention_heads'], prec)
    cls = h[:, 0]
    head = materialize({k: p[k] for k in ('pooler', 'classifier')})
    pooled = torch.tanh(prec.linear(cls, head['pooler']['kernel'],
                                    head['pooler']['bias'], 'text_bf16'))
    logits = prec.linear(pooled, head['classifier']['kernel'],
                         head['classifier']['bias'], 'text_bf16')
    return torch.softmax(logits, -1), cls
