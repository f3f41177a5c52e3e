"""The attention fusion net (the reference's MultiModalFusionModel):
per-modality Dense -> LayerNorm (eps 1e-5) -> ReLU projections to 256;
three cross-modal blocks, each modality's token attending over the other
two through 4-head packed-in-projection attention, residual and
LayerNorm; softmax attention pooling over the three; the decision MLP
over the 21 modality probabilities (21 -> 64 -> 3, softmax) weighting
them; the classifier on [fused | weighted] -> 256 -> LayerNorm -> ReLU
-> 128 -> ReLU -> 7, softmax. Judged on the reference's own features.
Stage 'fusion' (the program runs the Dense layers in bf16)."""

from __future__ import annotations

import math

import torch

INPUT = 'reference'
ST = 'fusion'


def _ln(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p['scale'] + p['bias']


def _dense(x, p, prec):
    return prec.linear(x, p['kernel'], p['bias'], ST)


def _proj(x, p, prec):
    return torch.relu(_ln(_dense(x, p['linear'], prec), p['norm']))


def _mha(q_in, kv, p, prec, heads=4):
    w, b = p['in_proj_weight'], p['in_proj_bias']
    e = w.shape[1]
    q = q_in @ w[:e].T + b[:e]
    k = kv @ w[e:2 * e].T + b[e:2 * e]
    v = kv @ w[2 * e:].T + b[2 * e:]
    B, Lq, Lk = q.shape[0], q.shape[1], k.shape[1]
    q = q.reshape(B, Lq, heads, -1).transpose(1, 2)
    k = k.reshape(B, Lk, heads, -1).transpose(1, 2)
    v = v.reshape(B, Lk, heads, -1).transpose(1, 2)
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(e // heads), -1)
    out = (a @ v).transpose(1, 2).reshape(B, Lq, e)
    return _dense(out, p['out_proj'], prec)


def forward(tree, feats, probs, prec):
    """feats: (speech 64, text 768, image 512); probs: three (B, 7)."""
    p = tree['params']
    sp, tp, ip = (_proj(f, p[f'{m}_proj'], prec)[:, None]
                  for f, m in zip(feats, ('speech', 'text', 'image')))
    enh = []
    for m, q, kv in (('speech', sp, (tp, ip)), ('text', tp, (sp, ip)),
                     ('image', ip, (sp, tp))):
        c = p[f'cross_attn_{m}']
        enh.append(_ln(q + _mha(q, torch.cat(kv, 1), c['attention'], prec),
                       c['norm'])[:, 0])
    af = p['attention_fusion']
    proj = [_proj(x, af[f'proj_{i}'], prec) for i, x in enumerate(enh)]
    a = _dense(torch.tanh(_dense(torch.cat(proj, -1), af['attn_0'], prec)),
               af['attn_1'], prec)
    w = torch.softmax(a, -1)
    fused = (torch.stack(proj, 1) * w[..., None]).sum(1)
    d = _dense(torch.relu(_dense(torch.cat(probs, -1), p['decision_0'],
                                 prec)), p['decision_1'], prec)
    dw = torch.softmax(d, -1)
    weighted = (torch.stack(probs, 1) * dw[..., None]).sum(1)
    x = torch.cat([fused, weighted], -1)
    x = torch.relu(_ln(_dense(x, p['classifier_0'], prec),
                       p['classifier_norm']))
    x = torch.relu(_dense(x, p['classifier_1'], prec))
    return torch.softmax(_dense(x, p['classifier_2'], prec), -1)
