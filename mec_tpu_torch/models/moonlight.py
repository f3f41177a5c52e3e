"""Moonlight-16B-A3B (deepseek_v3) as a sequence classifier: the decoder
over right-padded ids, a 2048->7 score head at the last real token.

Per layer: x += o(attention(rmsnorm(x))), then x += mlp(rmsnorm(x)); a
final RMSNorm. Attention is MLA without query compression, computed in
its expanded form (one forward over <= 128 tokens, no cache):
q = W_q x split per head into qk_nope_head_dim plain and
qk_rope_head_dim rotary dims; [c, k_r] = W_kv_a x; [k_n, v] = W_kv_b
rmsnorm(c) per head (eps LATENT_EPS); RoPE (theta rope_theta) on q_r
and the one k_r all heads share, in deepseek_v3's interleaved order; causal softmax at scale
1/sqrt(nope + rope). With right padding a real token attends only to
real tokens, so its logits do not depend on the sequence bucket.

The first first_k_dense_replace layers have a SwiGLU MLP
(intermediate_size); the rest a dropless expert layer with noaux_tc
routing (n_group = topk_group = 1): s = sigmoid(x W_g^T) in float32, the
top num_experts_per_tok of s + e_score_correction_bias (the bias chooses
and never weights), w = routed_scaling_factor * s_top / sum(s_top), and
out = sum_e w_e SwiGLU_e(x) + SwiGLU_shared(x). Padding tokens route to
no expert. The whole expert layer, from the residual stream to the
residual stream, goes through ops/expert_gemm.py (on a card the router,
the sort of the token-expert pairs, the grouped GEMM and the combine as
hand-written kernels; on the CPU their plain versions): the shared
experts as n_shared_experts more groups of the same GEMM with weight 1,
a token's pairs summed in float32 in slot order, then rounded once to
the compute dtype and added to the residual. Each expert layer counts,
on the device, the experts given at least one real token and the real
token-expert pairs.

The weights are a tree of tensors in the deepseek_v3 names (HF
DeepseekV3Model's, without the `model.` prefix) and nn.Linear's (out, in)
layout, except that each layer's routed experts are stacked:
mlp.experts.gate_proj and up_proj (E, moe_intermediate_size, H),
down_proj (E, H, moe_intermediate_size). The model computes in the
tree's dtype and keeps the tensors it is given: no copy is made.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from mec_tpu_torch.ops import expert_gemm

# the deepseek_v3 keys the model reads (config.json names)
FIELDS = ('hidden_size', 'num_hidden_layers', 'num_attention_heads',
          'intermediate_size', 'moe_intermediate_size', 'n_routed_experts',
          'n_shared_experts', 'num_experts_per_tok', 'first_k_dense_replace',
          'kv_lora_rank', 'qk_nope_head_dim', 'qk_rope_head_dim',
          'v_head_dim', 'rope_theta', 'rms_norm_eps',
          'routed_scaling_factor', 'norm_topk_prob', 'num_labels')
# the latent's RMSNorm (kv_a_layernorm) is built with deepseek_v3's
# default eps, not rms_norm_eps (modeling_deepseek_v3.py, and the model's
# own modeling_deepseek.py)
LATENT_EPS = 1e-6


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """deepseek_v3's RMSNorm: normalised in float32, rounded to x's dtype,
    then scaled."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight * xf.to(x.dtype)


def rope_tables(length: int, dim: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (length, dim) float32 of positions 0..length-1, each
    frequency twice (the rotate-half layout)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=device) / dim)
    freqs = torch.outer(torch.arange(length, dtype=torch.float32,
                                     device=device), inv)
    emb = torch.cat([freqs, freqs], -1)
    return emb.cos(), emb.sin()


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                     ) -> torch.Tensor:
    """deepseek_v3's interleaved RoPE (rope_interleave): the pairs (x0, x1),
    (x2, x3), ... rotate together; the result holds the rotated even dims,
    then the odd ones."""
    *lead, d = x.shape
    x = x.view(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos.to(x.dtype) + half * sin.to(x.dtype)


def swiglu(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, p['gate_proj']['weight']))
                    * F.linear(x, p['up_proj']['weight']),
                    p['down_proj']['weight'])


class MoonlightForClassification:
    """cfg: the FIELDS (a deepseek_v3 config.json plus num_labels); tree:
    the weights (module docstring)."""

    def __init__(self, tree: Dict, cfg: Dict):
        self.tree = tree
        self.cfg = {k: cfg[k] for k in FIELDS}
        self.n_moe = (cfg['num_hidden_layers']
                      - cfg['first_k_dense_replace'])

    def attention(self, h: torch.Tensor, p: Dict, cos, sin) -> torch.Tensor:
        c = self.cfg
        B, L, _ = h.shape
        nh, dn, dr, dv = (c['num_attention_heads'], c['qk_nope_head_dim'],
                          c['qk_rope_head_dim'], c['v_head_dim'])
        q = F.linear(h, p['q_proj']['weight']).view(B, L, nh, dn + dr) \
            .transpose(1, 2)
        q_n, q_r = q.split([dn, dr], -1)
        kv_a = F.linear(h, p['kv_a_proj_with_mqa']['weight'])
        latent, k_r = kv_a.split([c['kv_lora_rank'], dr], -1)
        kv = F.linear(rms_norm(latent, p['kv_a_layernorm']['weight'],
                               LATENT_EPS),
                      p['kv_b_proj']['weight']).view(B, L, nh, dn + dv) \
            .transpose(1, 2)
        k_n, v = kv.split([dn, dv], -1)
        q_r = rope_interleaved(q_r, cos, sin)
        k_r = rope_interleaved(k_r.view(B, 1, L, dr), cos, sin)
        q = torch.cat([q_n, q_r], -1)
        k = torch.cat([k_n, k_r.expand(B, nh, L, dr)], -1)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() \
            / math.sqrt(dn + dr)
        causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, float('-inf')),
                              -1).to(h.dtype)
        o = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, nh * dv)
        return F.linear(o, p['o_proj']['weight'])

    def expert_layer(self, x: torch.Tensor, p: Dict, valid: torch.Tensor,
                     counts: torch.Tensor) -> torch.Tensor:
        """x (T, H) -> x + the expert layer of the post-attention RMSNorm
        of x, in x's dtype; adds the layer's (experts given a real token,
        real token-expert pairs) into counts (2,) int32. On a card the
        router, the sort and the combine are one launch each around the
        grouped GEMM's two (ops/expert_gemm.py); on the CPU their plain
        versions."""
        c = self.cfg
        mlp = p['mlp']
        gate, ex, sh = mlp['gate'], mlp['experts'], mlp['shared_experts']
        h, idx, w = expert_gemm.expert_router(
            x, p['post_attention_layernorm']['weight'], gate['weight'],
            gate['e_score_correction_bias'], c['rms_norm_eps'],
            c['num_experts_per_tok'], c['norm_topk_prob'],
            c['routed_scaling_factor'])
        routing = expert_gemm.sort_pairs(idx, w, valid, c['n_routed_experts'],
                                         c['n_shared_experts'], counts)
        y = expert_gemm.grouped_expert_gemm(
            h, routing, ex['gate_proj'], ex['up_proj'], ex['down_proj'],
            sh['gate_proj']['weight'], sh['up_proj']['weight'],
            sh['down_proj']['weight'])
        return expert_gemm.combine_residual(x, y, routing, valid)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """ids, mask (B, L), right-padded -> logits (B, num_labels), the
        final-normed hidden state at the last real token (B, H), and the
        expert layers' counts summed over them (2,) int32: [experts
        touched, routed pairs]."""
        c, t = self.cfg, self.tree
        B, L = ids.shape
        eps = c['rms_norm_eps']
        x = t['embed_tokens']['weight'][ids]
        cos, sin = rope_tables(L, c['qk_rope_head_dim'], c['rope_theta'],
                               ids.device)
        valid = mask.reshape(-1) > 0
        counts = torch.zeros(2, dtype=torch.int32, device=ids.device)
        for i in range(c['num_hidden_layers']):
            p = t['layers'][str(i)]
            x = x + self.attention(rms_norm(x, p['input_layernorm']['weight'],
                                            eps), p['self_attn'], cos, sin)
            if i < c['first_k_dense_replace']:
                x = x + swiglu(rms_norm(
                    x, p['post_attention_layernorm']['weight'], eps), p['mlp'])
            else:
                x = self.expert_layer(x.view(B * L, -1), p, valid,
                                      counts).view(B, L, -1)
        last = (mask.sum(1) - 1).clamp_min(0).long()
        feat = rms_norm(x[torch.arange(B, device=ids.device), last],
                        t['norm']['weight'], eps)
        return F.linear(feat, t['score']['weight']), feat, counts

    __call__ = forward
