"""BERT-base sequence classifier: the port of mec_tpu/models/bert.py.

HuggingFace BertForSequenceClassification's inference graph, as the
Flax model computes it: embeddings (word + position + token type, then
LayerNorm eps 1e-12), post-LN encoder layers (explicit matmul
attention with an additive mask and an fp32 softmax), the tanh pooler
on [CLS] and the classifier. Returns (logits f32, the [CLS] last hidden
state f32).

The Flax dtype semantics are kept step for step, so bf16 serving rounds
where the reference rounds:
  * Dense(dtype) casts input and kernel to the compute dtype and adds the
    bias in it; Embed(dtype) returns rounded rows, and the three
    embeddings are summed in the compute dtype;
  * LayerNorm statistics (two-pass mean and variance: flax
    use_fast_variance=False) and the normalisation run in fp32 whatever
    the input dtype, and the result is cast back;
  * the additive mask is (1 - mask) * the float32 minimum, cast to the
    compute dtype (-inf in bf16), so padded keys get weight exactly 0.0
    and slicing a batch to a shorter sequence bucket changes no logit;
  * GELU is erf in fp32 parity mode and tanh in bf16 serving (set by the
    engine), evaluated in the activation dtype.

With quant=True (bf16 serving) the six encoder matmuls of every layer
are models.qconv.QuantDense (int8, per-token dynamic or calibrated
static activation scales). Module names follow the Flax tree, so
convert/from_jax.bert_state_from_jax maps it one to one.

With num_experts > 0 every layer's FFN is models.moe.MoEFFN (`moe` in
place of `intermediate` and `output`; the residual and output_norm
stay): the token mask is rebuilt from the additive bias (bias > -1), so
padding tokens never route, and forward(..., return_aux=True) also
returns the layers' load-balancing losses, one a layer. Under quant=True
only q, k, v and attention_output are int8; the expert bank stays in
the compute dtype, as in JAX (ops/quant.quantize_bert_params skips
`moe`).

Tensor, sequence and expert parallelism (parallel/partition.shard_bert,
over the mesh's 'model' axis): a layer whose `tp` is set holds its
column slice of q, k, v and `intermediate` (and the heads of it) and its
row slice of `attention_output` and `output`, or its experts' slice of
the bank, and runs the Megatron pattern through tp.enter / tp.exit
(identity in, all-reduce out; with sequence parallelism all-gather of
the sequence in, reduce-scatter out, the residual stream, LayerNorms
and dropout then on this rank's sequence shard); the row layers' biases
are added once, after the reduction. A block whose widths do not split
stays whole on every rank (tp.enter / tp.exit with sharded=False).

Training (module.training, the unquantized form): dropout_rate (HF's
hidden_dropout_prob, 0.1) after the embeddings' LayerNorm and after the
pooler's tanh, where the Flax model has its two dropouts, and with
remat=True each encoder layer is recomputed in the backward pass
(torch.utils.checkpoint, as nn.remat; an MoE layer's aux loss is a
layer output, so it is counted once). For bf16 training the caller
runs the fp32 model under torch.autocast.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mec_tpu_torch.models.batchnorm import remat as remat_layer
from mec_tpu_torch.models.batchnorm import wide
from mec_tpu_torch.models.moe import MoEFFN
from mec_tpu_torch.models.qconv import QuantDense


class Dense(nn.Linear):
    """flax nn.Dense(dtype): x and the kernel in the compute dtype, the
    bias added in it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight) + self.bias


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(use_fast_variance=False, dtype): fp32 statistics
    and affine, the result cast to `dtype`."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = wide(x)
        mu = x.mean(dim=-1, keepdim=True)
        d = x - mu
        var = (d * d).mean(dim=-1, keepdim=True)
        y = d * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


def dense(cin: int, cout: int, dtype: torch.dtype, quant: bool,
          quant_mode: str) -> nn.Module:
    if quant:
        return QuantDense(cin, cout, quant_mode, dtype)
    return Dense(cin, cout, dtype=dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype, quant, quant_mode):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        for name in ('query', 'key', 'value'):
            self.add_module(name, dense(hidden, hidden, dtype, quant,
                                        quant_mode))
        # jnp.sqrt(head_dim) in f32, cast to the compute dtype; a tensor,
        # so CUDA divides (a host-scalar division is a reciprocal multiply)
        hd = self.head_dim = hidden // heads
        self.register_buffer('scale', torch.sqrt(
            torch.tensor(float(hd), dtype=torch.float32)).to(dtype),
            persistent=False)

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, _H = h.shape

        def split(t):
            return t.reshape(B, L, -1, self.head_dim).transpose(1, 2)

        q, k, v = split(self.query(h)), split(self.key(h)), split(self.value(h))
        scores = (q @ k.transpose(-1, -2)) / self.scale
        scores = scores + bias[:, None, None, :]
        probs = torch.softmax(wide(scores), dim=-1).to(self.dtype)
        return (probs @ v).transpose(1, 2).reshape(B, L, -1)


class BertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, inter: int, dtype,
                 gelu_approximate: bool, quant: bool, quant_mode: str,
                 num_experts: int = 0, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.gelu = 'tanh' if gelu_approximate else 'none'
        self.attention_self = BertSelfAttention(hidden, heads, dtype, quant,
                                                quant_mode)
        self.attention_output = dense(hidden, hidden, dtype, quant,
                                      quant_mode)
        self.attention_norm = LayerNorm(hidden, 1e-12, dtype)
        if num_experts > 0:
            self.moe = MoEFFN(hidden, inter, num_experts,
                              moe_capacity_factor, dtype, gelu_approximate)
        else:
            self.intermediate = dense(hidden, inter, dtype, quant,
                                      quant_mode)
            self.output = dense(inter, hidden, dtype, quant, quant_mode)
        self.output_norm = LayerNorm(hidden, 1e-12, dtype)
        # parallel/partition.shard_bert: the 'model' axis and which blocks
        # hold a slice
        self.tp = None
        self.attn_sharded = self.ffn_sharded = False

    def forward(self, h: torch.Tensor, bias: torch.Tensor
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """The next hidden state; an MoE layer returns (it, aux loss)."""
        if self.tp is not None:
            return self._forward_tp(h, bias)
        ctx = self.attention_output(self.attention_self(h, bias))
        h = self.attention_norm(h + ctx)
        if hasattr(self, 'moe'):
            out, aux = self.moe(h, bias > -1.0)
            return self.output_norm(h + out), aux
        inter = F.gelu(self.intermediate(h), approximate=self.gelu)
        return self.output_norm(h + self.output(inter))

    @staticmethod
    def _row(layer: nn.Module, x: torch.Tensor, tp) -> torch.Tensor:
        """A row-parallel Dense: this rank's partial product, reduced over
        'model', then the bias once."""
        return tp.exit(F.linear(x.to(layer.weight.dtype), layer.weight),
                       True) + layer.bias

    def _forward_tp(self, h: torch.Tensor, bias: torch.Tensor):
        """forward on this rank's slices (parallel/partition.py); h is
        this rank's sequence shard under sequence parallelism."""
        tp = self.tp
        x = tp.enter(h, self.attn_sharded)
        ctx = self.attention_self(x, bias)
        att = (self._row(self.attention_output, ctx, tp) if self.attn_sharded
               else tp.exit(self.attention_output(ctx), False))
        h = self.attention_norm(h + att)
        if hasattr(self, 'moe'):
            out, aux = self.moe(tp.enter(h, False), bias > -1.0)
            return self.output_norm(h + tp.exit(out, self.moe.ep is not None)
                                    ), aux
        x = tp.enter(h, self.ffn_sharded)
        inter = F.gelu(self.intermediate(x), approximate=self.gelu)
        out = (self._row(self.output, inter, tp) if self.ffn_sharded
               else tp.exit(self.output(inter), False))
        return self.output_norm(h + out)


class BertForSequenceClassification(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2, num_classes: int = 7,
                 dtype: torch.dtype = torch.float32,
                 gelu_approximate: bool = False, quant: bool = False,
                 quant_mode: str = 'dynamic', dropout_rate: float = 0.1,
                 remat: bool = False, num_experts: int = 0,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        self.dtype, self.remat = dtype, remat
        self.num_experts = num_experts
        self.moe_capacity_factor = moe_capacity_factor
        # the widths, for a whole model rebuilt from shards
        # (parallel/partition.gather_bert)
        self.config = dict(
            vocab_size=vocab_size, hidden_size=hidden_size,
            num_layers=num_layers, num_heads=num_heads,
            intermediate_size=intermediate_size, max_position=max_position,
            type_vocab_size=type_vocab_size, num_classes=num_classes,
            num_experts=num_experts, moe_capacity_factor=moe_capacity_factor)
        self.tp = None      # parallel/partition.shard_bert
        self.dropout = nn.Dropout(dropout_rate)
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size,
                                            dtype=dtype)
        self.position_embeddings = nn.Embedding(max_position, hidden_size,
                                                dtype=dtype)
        self.token_type_embeddings = nn.Embedding(type_vocab_size,
                                                  hidden_size, dtype=dtype)
        self.embeddings_norm = LayerNorm(hidden_size, 1e-12, dtype)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f'layer_{i}', BertLayer(
                hidden_size, num_heads, intermediate_size, dtype,
                gelu_approximate, quant, quant_mode, num_experts,
                moe_capacity_factor))
        self.pooler = Dense(hidden_size, hidden_size, dtype=dtype)
        self.classifier = Dense(hidden_size, num_classes, dtype=dtype)
        # the f32 minimum, cast where the mask is built: -inf in bf16
        self.register_buffer('neg', torch.tensor(
            torch.finfo(torch.float32).min), persistent=False)
        self.eval()    # the Flax models' train=False default

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                return_aux: bool = False
                ) -> Union[Tuple[torch.Tensor, torch.Tensor],
                           Tuple[torch.Tensor, torch.Tensor,
                                 List[torch.Tensor]]]:
        """(B, L) integer ids and mask -> (logits (B, C) f32, [CLS]
        hidden state (B, H) f32); token types are all 0. return_aux: also
        the MoE layers' load-balancing losses (an empty list without
        experts)."""
        ids = input_ids.long()
        L = ids.shape[1]
        pos = torch.arange(L, device=ids.device)
        h = (self.word_embeddings(ids) + self.position_embeddings(pos)[None]
             + self.token_type_embeddings(torch.zeros_like(ids)))
        h = self.dropout(self.embeddings_norm(h))
        if self.tp is not None:
            h = self.tp.scatter(h)     # sequence parallelism: this shard
        bias = ((1.0 - attention_mask.float()) * self.neg).to(self.dtype)
        aux = []
        for i in range(self.num_layers):
            layer = getattr(self, f'layer_{i}')
            h = (remat_layer(layer, h, bias) if self.remat and self.training
                 else layer(h, bias))
            if self.num_experts > 0:
                h, a = h
                aux.append(a)
        if self.tp is not None:
            h = self.tp.gather(h)
        cls = h[:, 0, :]
        pooled = self.dropout(torch.tanh(self.pooler(cls)))
        logits = self.classifier(pooled)
        if return_aux:
            return wide(logits), wide(cls), aux
        return wide(logits), wide(cls)
