"""Mixture-of-Experts FFN: the port of mec_tpu/models/moe.py.

A top-1-routed expert bank in place of BERT's dense FFN, with the Flax
module's names and shapes (router Dense (H -> E); wi (E, H, F), wo
(E, F, H), bi (E, F), bo (E, H), all fp32 parameters) and its
GShard/Switch semantics, step for step:

  * the router runs in fp32 on the fp32 cast of the hidden states; the
    expert is the argmax of its softmax (the first index on ties);
  * padding tokens (mask 0) never route: they claim no capacity, add
    nothing to the aux loss and output 0;
  * the routing group is ONE EXAMPLE: a token's position in its expert
    is a cumsum over its own example's tokens, and tokens past the
    static per-example capacity C = max(1, int(capacity_factor * L / E))
    drop to 0 (the caller's residual passes them through). C depends on
    the padded length L, as in JAX, so a serving bucket and an eval
    length agree exactly when no expert overflows the smaller C;
  * dispatch in fp32, cast to the compute dtype; the two expert GEMMs in
    the compute dtype with erf or tanh GELU; the gate-weighted combine
    in fp32, cast to the compute dtype.

The JAX module's one-hot einsums are written as an index gather
(dispatch) and a gather of each token's slot (combine). Every (example,
expert, slot) holds at most one token, so the einsum's sum is an exact
selection and the two forms are equal bit for bit (pinned by
tests/test_torch_moe.py against the Flax module). The expert GEMMs are
one batched matmul over the experts.

The load-balancing loss E * sum_e frac_e * P_e (means over real
tokens) is returned beside the output: forward -> (y, aux). Inside a
data-parallel fit (parallel/mesh.data_parallel) the per-rank sums of
the one-hots, the probabilities and the token count are all-reduced
(autograd-aware) before the means are taken, so the aux loss is the
global batch's, as JAX's GSPMD computes it (a product of two means is
not the mean of per-rank products).

router_jitter (train time only, default 0; BertLayer never sets it)
multiplies the logits by U(1 - j, 1 + j) drawn from the explicit
torch.Generator given as `generator`.

Expert parallelism (JAX's ep_axis over the mesh's 'model' axis; set by
parallel/partition.shard_bert): with `ep` set, this rank holds experts
[expert_offset, expert_offset + E/m) of the E in wi, wo, bi, bo. The
router stays whole and every rank routes every token, so routing,
capacity and positions are unchanged; the rank runs its own experts'
slots and returns its part of the gate-weighted combine (zero for
tokens routed elsewhere), which the caller sums over 'model'. The
tokens' rows and the gates enter the expert path through ep.copy
(identity forward, all-reduce backward), so their gradients, like the
router's, are whole on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mec_tpu_torch.models.batchnorm import wide
from mec_tpu_torch.parallel import mesh as pmesh


class MoEFFN(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_experts: int = 4, capacity_factor: float = 1.25,
                 dtype: torch.dtype = torch.float32,
                 gelu_approximate: bool = False, router_jitter: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        E, H, Fi = num_experts, hidden_size, intermediate_size
        self.num_experts, self.capacity_factor = E, capacity_factor
        self.dtype = dtype
        self.gelu = 'tanh' if gelu_approximate else 'none'
        self.router_jitter, self.generator = router_jitter, generator
        self.router = nn.Linear(H, E)
        self.wi = nn.Parameter(torch.empty(E, H, Fi))
        self.wo = nn.Parameter(torch.empty(E, Fi, H))
        self.bi = nn.Parameter(torch.zeros(E, Fi))
        self.bo = nn.Parameter(torch.zeros(E, H))
        self.ep, self.expert_offset = None, 0

    def forward(self, hidden: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, H) hidden and an optional (B, L) token mask -> (y (B, L,
        H) in the compute dtype, the aux loss, a scalar)."""
        B, L, H = hidden.shape
        E = self.num_experts
        C = max(1, int(self.capacity_factor * L / E))   # static, >= 1
        with torch.autocast(hidden.device.type, enabled=False):
            x = wide(hidden)
            acc = x.dtype
            m = (torch.ones(B, L, dtype=acc, device=x.device) if mask is None
                 else mask.to(acc))
            logits = F.linear(x, self.router.weight.to(acc),
                              self.router.bias.to(acc))          # (B, L, E)
            if self.training and self.router_jitter > 0.0:
                if self.generator is None:
                    raise ValueError('router_jitter > 0 draws from an '
                                     'explicit generator: pass generator=')
                u = torch.rand(logits.shape, generator=self.generator,
                               device=self.generator.device).to(logits)
                logits = logits * (1.0 - self.router_jitter
                                   + 2.0 * self.router_jitter * u)
            probs = torch.softmax(logits, dim=-1)
            expert = torch.argmax(probs, dim=-1)                 # (B, L)
            onehot = F.one_hot(expert, E).to(acc) * m[..., None]
            gate = (probs * onehot).sum(dim=-1)                  # (B, L)
            aux = self._aux(onehot, probs, m)
            if self.ep is not None:
                x, gate = self.ep.copy(x), self.ep.copy(gate)

            # 1-based position within the expert where routed; past C drops
            pos = ((torch.cumsum(onehot, dim=1) * onehot).sum(dim=-1)
                   - 1.0).long()                                 # (B, L)
            keep = (pos >= 0) & (pos < C)
            n_slots = B * E * C
            b_idx = torch.arange(B, device=x.device)[:, None]
            slot = torch.where(keep, (b_idx * E + expert) * C + pos,
                               n_slots).reshape(-1)              # (B*L,)
            # slot -> token (a zero row for empty slots); dropped and
            # padding tokens all land in the extra slot n_slots
            src = torch.full((n_slots + 1,), B * L, dtype=torch.long,
                             device=x.device)
            src.scatter_(0, slot, torch.arange(B * L, device=x.device))
            rows = torch.cat([x.reshape(B * L, H), x.new_zeros(1, H)])
            xin = rows[src[:n_slots]].to(self.dtype)             # (B*E*C, H)

        xin = xin.reshape(B, E, C, H).transpose(0, 1)
        lo, n_local = self.expert_offset, self.wi.shape[0]
        xin = xin[lo:lo + n_local].reshape(n_local, B * C, H)
        h = torch.bmm(xin, self.wi.to(self.dtype)) \
            + self.bi.to(self.dtype)[:, None, :]
        h = F.gelu(h, approximate=self.gelu)
        out = torch.bmm(h, self.wo.to(self.dtype)) \
            + self.bo.to(self.dtype)[:, None, :]                 # (E, B*C, H)

        with torch.autocast(hidden.device.type, enabled=False):
            out = out.reshape(n_local, B, C, H).transpose(0, 1)
            if n_local < E:
                # the other ranks' experts' slots: zero here
                out = torch.cat([out.new_zeros(B, lo, C, H), out,
                                 out.new_zeros(B, E - lo - n_local, C, H)],
                                dim=1)
            out = out.reshape(n_slots, H)
            out = torch.cat([out.to(acc), out.new_zeros(1, H, dtype=acc)])
            y = out[slot].reshape(B, L, H) * gate[..., None]
        return y.to(self.dtype), aux

    def _aux(self, onehot: torch.Tensor, probs: torch.Tensor,
             m: torch.Tensor) -> torch.Tensor:
        """E * sum_e frac_e * P_e over the real tokens of the batch (of
        the global batch inside a data-parallel fit)."""
        E = self.num_experts
        sums = torch.cat([onehot.sum(dim=(0, 1)),
                          (probs * m[..., None]).sum(dim=(0, 1)),
                          m.sum()[None]])
        dmesh = pmesh.active()
        if dmesh is not None and self.training:
            sums = dmesh.all_reduce_sum(sums)
        denom = torch.clamp(sums[-1], min=1.0)
        return E * torch.sum((sums[:E] / denom) * (sums[E:2 * E] / denom))
