"""Moonlight-16B-A3B (deepseek_v3, https://huggingface.co/moonshotai/
Moonlight-16B-A3B config.json) as a sequence classifier, in plain float32,
written from the equations:

  h = embed[ids]; per layer l:
    h += W_o attn(rmsnorm(h)); h += mlp_l(rmsnorm(h))
  logits = W_score rmsnorm(h)[last real token]

rmsnorm(x) = x / sqrt(mean(x^2) + eps) * w, eps rms_norm_eps but for the
latent's norm, built with deepseek_v3's default 1e-6. Attention is MLA without
query compression: q = W_q x, per head nope + rope dims; [c, k_r] =
W_kv_a x; [k_n, v] = W_kv_b rmsnorm(c), per head; the rope dims of q and
the one k_r of all heads rotate by position p, pair (2j, 2j+1) by the
angle p * theta^(-2j / rope_dim); softmax(q k^T / sqrt(nope + rope))
over the keys at or before the query, times v. Layers before
first_k_dense_replace have a SwiGLU MLP, w_down (silu(w_gate x) *
w_up x); the others an expert layer: s = sigmoid(W_g x), the top k
experts of s + e_score_correction_bias, weights routed_scaling_factor *
s_e / sum of the chosen s, out = sum over the chosen of weight x
SwiGLU_e(x), plus the shared SwiGLU. Padding tokens route to no expert.
Returns (probs, the final-normed hidden state at the last real token).

Departures from the published model: no LM head (a score head of
num_labels in its place, as a classifier has); the tokenizer is the
benchmark's WordPiece (configuration, `assumed`).

Stages: every product of the decoder, the router, the experts and the
head is 'text_bf16': the program computes each on bf16 operands (the
router's product it sums and returns in float32, as its GEMMs sum).
Seeded leaves
(benchmark/weights/seeded.py) are drawn a layer at a time and dropped,
in bf16, the dtype the configuration holds this leg's weights in, and
widened to float32: the reference computes exactly on the weights the
program is given."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.weights.seeded import materialize


def _draw(tree):
    """A (sub)tree's seeded leaves drawn in bf16, widened to float32."""
    return _widen(materialize(tree, torch.bfloat16))


def _widen(tree):
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.float() if isinstance(tree, torch.Tensor) else tree


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _lin(x, w, prec):
    """x W^T of a weight in the (out, in) layout."""
    return prec.linear(x, w.T, None, 'text_bf16')


def _rotate(x, pos, theta):
    """Each pair (2j, 2j+1) of the last dim turned by pos * theta^(-2j/d)."""
    d = x.shape[-1]
    ang = pos[:, None] * theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                                 device=x.device) / d)
    c, s = ang.cos(), ang.sin()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1).flatten(-2)


def _attention(x, p, text, prec):
    B, L, _ = x.shape
    nh, dn, dr, dv = (text['num_attention_heads'], text['qk_nope_head_dim'],
                      text['qk_rope_head_dim'], text['v_head_dim'])
    pos = torch.arange(L, dtype=torch.float32, device=x.device)
    q = _lin(x, p['q_proj']['weight'], prec).view(B, L, nh, dn + dr) \
        .transpose(1, 2)
    kv_a = _lin(x, p['kv_a_proj_with_mqa']['weight'], prec)
    c, k_r = kv_a[..., :text['kv_lora_rank']], kv_a[..., text['kv_lora_rank']:]
    kv = _lin(_rms(c, p['kv_a_layernorm']['weight'], 1e-6),
              p['kv_b_proj']['weight'], prec).view(B, L, nh, dn + dv) \
        .transpose(1, 2)
    q = torch.cat([q[..., :dn], _rotate(q[..., dn:], pos, text['rope_theta'])],
                  -1)
    k_r = _rotate(k_r, pos, text['rope_theta'])[:, None].expand(B, nh, L, dr)
    k = torch.cat([kv[..., :dn], k_r], -1)
    scores = prec.matmul(q, k.transpose(-1, -2), 'text_bf16') \
        / math.sqrt(dn + dr)
    future = torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float('-inf')), -1)
    o = prec.matmul(probs, kv[..., dn:], 'text_bf16').transpose(1, 2) \
        .reshape(B, L, nh * dv)
    return _lin(o, p['o_proj']['weight'], prec)


def _swiglu(x, gate, up, down, prec):
    return _lin(F.silu(_lin(x, gate, prec)) * _lin(x, up, prec), down, prec)


def _experts(x, p, valid, text, prec):
    """x (T, H), valid (T,) bool -> (T, H): the routed experts of each real
    token, one expert at a time, plus the shared experts."""
    g = p['gate']
    scores = torch.sigmoid(_lin(x, g['weight'], prec))
    top = torch.topk(scores + g['e_score_correction_bias'],
                     text['num_experts_per_tok'], -1).indices
    w = scores.gather(1, top)
    if text['norm_topk_prob']:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * text['routed_scaling_factor']
    ex = p['experts']
    out = torch.zeros_like(x)
    for e in range(text['n_routed_experts']):
        tok, slot = ((top == e) & valid[:, None]).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(x[tok], ex['gate_proj'][e], ex['up_proj'][e],
                        ex['down_proj'][e], prec)
            out.index_add_(0, tok, y * w[tok, slot][:, None])
    sh = p['shared_experts']
    return out + _swiglu(x, sh['gate_proj']['weight'], sh['up_proj']['weight'],
                         sh['down_proj']['weight'], prec)


def forward(tree, ids: torch.Tensor, mask: torch.Tensor, text, prec):
    """text: the configuration's text table."""
    B, L = ids.shape
    eps = text['rms_norm_eps']
    h = materialize(tree['embed_tokens'], torch.bfloat16)['weight'][ids] \
        .float()
    valid = mask.reshape(-1) > 0
    for i in range(text['num_hidden_layers']):
        p = _draw(tree['layers'][str(i)])
        h = h + _attention(_rms(h, p['input_layernorm']['weight'], eps),
                           p['self_attn'], text, prec)
        x = _rms(h, p['post_attention_layernorm']['weight'], eps)
        m = p['mlp']
        if i < text['first_k_dense_replace']:
            h = h + _swiglu(x, m['gate_proj']['weight'], m['up_proj']['weight'],
                            m['down_proj']['weight'], prec)
        else:
            h = h + _experts(x.reshape(B * L, -1), m, valid, text,
                             prec).view(B, L, -1)
        del p, m
    last = mask.long().sum(1) - 1
    head = _draw({k: tree[k] for k in ('norm', 'score')})
    feat = _rms(h[torch.arange(B, device=ids.device), last],
                head['norm']['weight'], eps)
    logits = _lin(feat, head['score']['weight'], prec)
    return torch.softmax(logits, -1), feat
