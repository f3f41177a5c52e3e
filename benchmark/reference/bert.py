"""BERT-base for sequence classification (HF BertForSequenceClassification
at inference): word + position + token-type-0 embeddings, LayerNorm
(eps 1e-12); post-LN layers of 12-head attention (scores / sqrt(64), the
additive mask (1 - mask) * float32 min, softmax) and an erf-GELU FFN;
the tanh pooler on [CLS] and the classifier. Returns (probs, the [CLS]
last hidden state, the fusion's text feature).

Stages: the six encoder matmuls of a layer are 'text_int8' (the program
runs them in int8), the attention products, embeddings' sum, pooler and
classifier 'text_bf16'."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ln(x, p, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p['scale'] + p['bias']


def forward(tree, ids: torch.Tensor, mask: torch.Tensor, heads: int, prec):
    p = tree['params']
    B, L = ids.shape
    h = (p['word_embeddings']['embedding'][ids]
         + p['position_embeddings']['embedding'][:L][None]
         + p['token_type_embeddings']['embedding'][0])
    h = _ln(prec.values(h, 'text_bf16'), p['embeddings_norm'], 1e-12)
    bias = (1.0 - mask.float()) * torch.finfo(torch.float32).min
    i = 0
    while f'layer_{i}' in p:
        lp = p[f'layer_{i}']
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
        h = _ln(h + out, lp['output_norm'], 1e-12)
        i += 1
    cls = h[:, 0]
    pooled = torch.tanh(prec.linear(cls, p['pooler']['kernel'],
                                    p['pooler']['bias'], 'text_bf16'))
    logits = prec.linear(pooled, p['classifier']['kernel'],
                         p['classifier']['bias'], 'text_bf16')
    return torch.softmax(logits, -1), cls
