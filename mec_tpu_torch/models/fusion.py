"""Attention-based multimodal fusion network: the port of
mec_tpu/models/fusion.py (itself the reference's PyTorch
MultiModalFusionModel, reference inference/multimodal_fusion.py:108-182).

  * per-modality projection Dense -> LayerNorm -> ReLU (speech 64 /
    text 768 / image 512 -> hidden 256);
  * three cross-modal blocks: each modality's token queries the other
    two through a 4-head packed-in-proj MHA (torch.nn.MultiheadAttention
    semantics), then residual + LayerNorm;
  * softmax attention pooling over the three enhanced streams;
  * the decision-weight MLP over the concatenated per-modality softmax
    vectors (21 -> 64 -> 3 -> softmax);
  * the classifier on [fused(256) | weighted preds(7)] -> 256 -> 128 -> 7.

Returns (logits f32, attention weights (B, 3) f32, decision weights
(B, 3) f32). LayerNorms use eps 1e-5 with fp32 statistics, softmaxes
run in fp32, and the compute dtype rounds where the Flax model rounds.
One detail of that model carries over: the MHA's in_proj_weight and
in_proj_bias are raw parameters that the serving engine keeps in fp32,
so in bf16 serving the q/k/v projections, scores and context are fp32
(bf16 inputs promoted), and only the out-projection (a Dense) is bf16.
Module names follow the Flax tree (convert/from_jax.fusion_state_from_jax).
In training mode the Flax model's dropouts apply: 0.3 after each
projection's ReLU, 0.1 on each cross-modal attention output before its
residual, 0.4 and 0.3 after the classifier's two hidden ReLUs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mec_tpu_torch.models.batchnorm import wide
from mec_tpu_torch.models.bert import Dense, LayerNorm

EPS = 1e-5


class TorchMultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        e = embed_dim
        self.heads, self.dtype = num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e))
        self.out_proj = Dense(e, e, dtype=dtype)
        # jnp.sqrt(head_dim) in f32, cast to the compute dtype
        self.register_buffer('scale', torch.sqrt(torch.tensor(
            float(e // num_heads))).to(dtype), persistent=False)

    def forward(self, query: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        e, h = self.in_proj_weight.shape[1], self.heads
        w, b = self.in_proj_weight, self.in_proj_bias
        query, kv = query.to(w.dtype), kv.to(w.dtype)
        q = query @ w[:e].T + b[:e]
        k = kv @ w[e:2 * e].T + b[e:2 * e]
        v = kv @ w[2 * e:].T + b[2 * e:]
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        q = q.reshape(B, Lq, h, e // h).transpose(1, 2)
        k = k.reshape(B, Lk, h, e // h).transpose(1, 2)
        v = v.reshape(B, Lk, h, e // h).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / self.scale.to(q.dtype)
        attn = torch.softmax(wide(scores), dim=-1).to(self.dtype)
        out = (attn.to(v.dtype) @ v).transpose(1, 2).reshape(B, Lq, e)
        return self.out_proj(out)


class CrossModalAttention(nn.Module):
    def __init__(self, hidden: int, dtype: torch.dtype, num_heads: int = 4):
        super().__init__()
        self.attention = TorchMultiheadAttention(hidden, num_heads, dtype)
        self.norm = LayerNorm(hidden, EPS, dtype)
        self.dropout = nn.Dropout(0.1)

    def forward(self, query: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        return self.norm(query + self.dropout(self.attention(query, kv)))


class Projection(nn.Module):
    """Dense -> LayerNorm -> ReLU -> Dropout(0.3)."""

    def __init__(self, din: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.linear = Dense(din, hidden, dtype=dtype)
        self.norm = LayerNorm(hidden, EPS, dtype)
        self.dropout = nn.Dropout(0.3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dropout(F.relu(self.norm(self.linear(x))))


class AttentionFusion(nn.Module):
    def __init__(self, hidden: int, dtype: torch.dtype, n: int = 3):
        super().__init__()
        self.dtype, self.n = dtype, n
        for i in range(n):
            self.add_module(f'proj_{i}', Projection(hidden, hidden, dtype))
        self.attn_0 = Dense(n * hidden, hidden, dtype=dtype)
        self.attn_1 = Dense(hidden, n, dtype=dtype)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        projected = [getattr(self, f'proj_{i}')(f) for i, f in enumerate(feats)]
        a = self.attn_1(torch.tanh(self.attn_0(torch.cat(projected, dim=-1))))
        weights = torch.softmax(wide(a), dim=-1)              # (B, M)
        stacked = torch.stack(projected, dim=1)                 # (B, M, H)
        fused = (stacked * weights[..., None].to(self.dtype)).sum(dim=1)
        return fused, weights


class MultiModalFusionModel(nn.Module):
    def __init__(self, speech_dim: int = 64, text_dim: int = 768,
                 image_dim: int = 512, num_classes: int = 7,
                 hidden_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        h = hidden_dim
        self.dtype = dtype
        self.speech_proj = Projection(speech_dim, h, dtype)
        self.text_proj = Projection(text_dim, h, dtype)
        self.image_proj = Projection(image_dim, h, dtype)
        self.cross_attn_speech = CrossModalAttention(h, dtype)
        self.cross_attn_text = CrossModalAttention(h, dtype)
        self.cross_attn_image = CrossModalAttention(h, dtype)
        self.attention_fusion = AttentionFusion(h, dtype)
        self.decision_0 = Dense(3 * num_classes, 64, dtype=dtype)
        self.decision_1 = Dense(64, 3, dtype=dtype)
        self.classifier_0 = Dense(h + num_classes, h, dtype=dtype)
        self.classifier_norm = LayerNorm(h, EPS, dtype)
        self.classifier_1 = Dense(h, h // 2, dtype=dtype)
        self.classifier_2 = Dense(h // 2, num_classes, dtype=dtype)
        self.dropout_0 = nn.Dropout(0.4)
        self.dropout_1 = nn.Dropout(0.3)
        self.eval()    # the Flax models' train=False default

    def forward(self, speech_feat, text_feat, image_feat,
                speech_pred, text_pred, image_pred):
        """All inputs (B, dim) -> (logits, attention_w, decision_w)."""
        sp = self.speech_proj(speech_feat)[:, None]
        tp = self.text_proj(text_feat)[:, None]
        ip = self.image_proj(image_feat)[:, None]
        s_enh = self.cross_attn_speech(sp, torch.cat([tp, ip], dim=1))[:, 0]
        t_enh = self.cross_attn_text(tp, torch.cat([sp, ip], dim=1))[:, 0]
        i_enh = self.cross_attn_image(ip, torch.cat([sp, tp], dim=1))[:, 0]
        fused, attention_weights = self.attention_fusion(
            [s_enh, t_enh, i_enh])

        preds = (speech_pred, text_pred, image_pred)
        all_preds = torch.cat(preds, dim=-1).to(self.dtype)
        d = self.decision_1(F.relu(self.decision_0(all_preds)))
        decision_weights = torch.softmax(wide(d), dim=-1)
        stacked = torch.stack(preds, dim=1).to(self.dtype)
        weighted = (stacked * decision_weights[..., None].to(self.dtype)
                    ).sum(dim=1)

        x = torch.cat([fused, weighted], dim=-1)
        x = self.dropout_0(F.relu(self.classifier_norm(self.classifier_0(x))))
        x = self.dropout_1(F.relu(self.classifier_1(x)))
        logits = self.classifier_2(x)
        return wide(logits), attention_weights, decision_weights
