"""SpeechDNN: five Dense -> BatchNorm (eps 1e-3, running statistics) ->
ReLU blocks (512/512/256/128/64), Dense(7), softmax. Returns (probs,
the last block's output, the fusion's 64-dim speech feature)."""

from __future__ import annotations

import torch


def forward(tree, x: torch.Tensor, prec, stage: str = 'speech_dnn'):
    p, s = tree['params'], tree['batch_stats']
    i = 0
    while f'dense_{i}' in p:
        d, bn, st = p[f'dense_{i}'], p[f'bn_{i}'], s[f'bn_{i}']
        x = prec.linear(x, d['kernel'], d['bias'], stage)
        x = (x - st['mean']) / torch.sqrt(st['var'] + 1e-3) * bn['scale'] \
            + bn['bias']
        x = torch.relu(x)
        i += 1
    logits = prec.linear(x, p['dense_out']['kernel'], p['dense_out']['bias'],
                         stage)
    return torch.softmax(logits, -1), x
