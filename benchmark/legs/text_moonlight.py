"""Moonlight-16B-A3B's text leg (deepseek_v3): its decoder in the published
layout, every leaf seeded (benchmark/weights/seeded.py), drawn alone on
the card where it is used: by engine_kwargs in bf16 for the program, a
layer at a time in float32 by the reference (benchmark/reference/
moonlight.py).

The leaves are HF DeepseekV3Model's names and (out, in) shapes, except
that each layer's 64 routed experts are stacked in the layout the
program's grouped expert GEMM reads (mlp.experts.gate_proj and up_proj
(E, moe_intermediate_size, H), down_proj (E, H, moe_intermediate_size)),
drawn in that layout, so nothing is repacked. No LM head: a score head
of num_labels. The init is deepseek_v3's (N(0, 0.02) kernels, RMSNorm
scales 1) but for two leaves:

- e_score_correction_bias is nonzero (uniform in [-0.01, 0.01]): a
  trained model's bias is not zero, and a zero bias would leave the
  selection path untested; it is small next to the sigmoid scores'
  spread (~0.2), so it flips near-ties and leaves the expected load of
  every expert about even, as a trained bias keeps it.
- the routed experts' down projections are drawn at
  0.02 / sqrt(n_routed_experts), the scale a fan-in init gives the down
  projection of one MLP n_routed_experts times as wide. At 0.02 the 26
  top-6 layers are chaotic under bf16: a near-tie that rounding flips in
  one layer moves the next layers' router inputs enough to flip more,
  and the last token's logits come out nearly unrelated to the float32
  reference's, so no limit of the output check separates the program
  from its fp8 control. With the routed sum a smaller part of each
  layer's update the cascade dies out, and the check sees a fault in
  the experts (PERF.md).

The embedding has embedding_rows rows (the published 163,840); the
tokenizer's ids index its first vocab_size."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.weights import seeded

STD = 0.02      # deepseek_v3's initializer_range: every kernel
BIAS = 0.01     # the correction bias: uniform in [-BIAS, BIAS]

# the tiny copy's widths: 1 dense + 2 expert layers, 16 experts, top 6,
# 2 shared, small MLA dims, over the full embedding
TINY = {'hidden_size': 64, 'num_hidden_layers': 3, 'num_attention_heads': 2,
        'intermediate_size': 128, 'moe_intermediate_size': 32,
        'n_routed_experts': 16, 'kv_lora_rank': 16, 'qk_nope_head_dim': 16,
        'qk_rope_head_dim': 8, 'v_head_dim': 16}


def routed_down_std(n_routed_experts: int) -> float:
    """The routed experts' down projections' std (module docstring)."""
    return STD / math.sqrt(n_routed_experts)


def plan(d, hidden_size: int, num_hidden_layers: int,
         num_attention_heads: int, intermediate_size: int,
         moe_intermediate_size: int, n_routed_experts: int,
         n_shared_experts: int, first_k_dense_replace: int,
         kv_lora_rank: int, qk_nope_head_dim: int, qk_rope_head_dim: int,
         v_head_dim: int, embedding_rows: int, num_labels: int,
         **_ignored) -> Dict:
    """The decoder's tree of seeded leaves (d, the run's Draws, is not
    used: every leaf is drawn alone)."""
    H, E, Im = hidden_size, n_routed_experts, moe_intermediate_size
    nh = num_attention_heads

    def lin(out, inp):
        return {'weight': seeded.normal(out, inp, std=STD)}

    def norm(n):
        return {'weight': seeded.full(1.0, n)}

    layers = {}
    for i in range(num_hidden_layers):
        attn = {'q_proj': lin(nh * (qk_nope_head_dim + qk_rope_head_dim), H),
                'kv_a_proj_with_mqa': lin(kv_lora_rank + qk_rope_head_dim, H),
                'kv_a_layernorm': norm(kv_lora_rank),
                'kv_b_proj': lin(nh * (qk_nope_head_dim + v_head_dim),
                                 kv_lora_rank),
                'o_proj': lin(H, nh * v_head_dim)}
        if i < first_k_dense_replace:
            mlp = {'gate_proj': lin(intermediate_size, H),
                   'up_proj': lin(intermediate_size, H),
                   'down_proj': lin(H, intermediate_size)}
        else:
            S = n_shared_experts * Im
            mlp = {'gate': {'weight': seeded.normal(E, H, std=STD),
                            'e_score_correction_bias':
                                seeded.uniform(-BIAS, BIAS, E)},
                   'experts': {'gate_proj': seeded.normal(E, Im, H, std=STD),
                               'up_proj': seeded.normal(E, Im, H, std=STD),
                               'down_proj': seeded.normal(
                                   E, H, Im, std=routed_down_std(E))},
                   'shared_experts': {'gate_proj': lin(S, H),
                                      'up_proj': lin(S, H),
                                      'down_proj': lin(H, S)}}
        layers[str(i)] = {'input_layernorm': norm(H), 'self_attn': attn,
                          'post_attention_layernorm': norm(H), 'mlp': mlp}
    return {'embed_tokens': lin(embedding_rows, H), 'layers': layers,
            'norm': norm(H), 'score': lin(num_labels, H)}


def engine_kwargs(text: Dict, tree: Dict, vocab) -> Dict:
    """EmotionEngine's Moonlight keywords: every leaf drawn in bf16 on the
    run's device (where make_trees bound it) and handed over as is."""
    return dict(text_arch='moonlight',
                text_variables=seeded.materialize(tree, torch.bfloat16),
                text_kwargs=dict(text), text_vocab=vocab)
