"""Tensor, sequence and expert parallelism over the mesh's 'model' axis:
the port of mec_tpu/parallel/partition.py, with what GSPMD derives from
its rules written out.

bert_partition_rules and partition_spec_for are JAX's, copied (pinned
by tests/test_torch_partition.py): path-suffix rules over the Flax tree,
a spec being the tuple of mesh axes of a PartitionSpec ((None, 'model')
for P(None, 'model'), () for P()). shard_bert applies them to the port's
module on this rank of the mesh, as JAX's shard_variables places the
tree: split_dim reads each parameter's spec from its Flax path, and a
rule that shards a leaf outside the blocks below raises. Where a
dimension does not divide by the axis size JAX falls back to
replication per leaf; here a block (a layer's attention, its FFN, its
expert bank) holds slices only when all its sharded leaves divide, and
the attention splits by whole heads, so a head count that does not
divide leaves that block whole too. Each rank then holds:

  * the column slice of q, k and v (its heads) and of `intermediate`,
    with their bias slices;
  * the row slice of `attention_output` and `output` (their biases whole,
    added once after the reduction);
  * in an MoE layer, its experts' slice of wi, wo, bi, bo (expert
    parallelism; the router whole);
  * everything else whole.

GSPMD inserts the collectives from the shardings; here the layers run
them through a TensorParallel (models/bert.py BertLayer._forward_tp),
built from four autograd-aware operations over the 'model' group:

  * copy-to-TP: identity forward, all-reduce backward, before the column
    layers (their input's gradient is a partial sum on each rank);
  * reduce-from-TP: all-reduce forward, identity backward, after the row
    layers;
  * with sequence parallelism (seq_parallel, JAX's seq_spec): the
    residual stream between the blocks holds this rank's contiguous
    sequence shard; all-gather of the sequence before a block (backward:
    reduce-scatter), reduce-scatter after it (backward: all-gather), in
    place of the two above. The embeddings are computed whole and split
    (backward: all-gather), and the last hidden state gathered again
    before the pooler. LayerNorms, the residual adds and the row biases
    run on the shard, so their gradients are partial sums over 'model'
    (marked in model.mec_axes for the fit to all-reduce).

model.mec_axes maps each parameter name to (the axes it is sharded
over, the axes its gradient is a partial sum over): the clip's global
norm counts a sharded leaf once across its axes and a whole leaf once,
as optax's norm of the full tree does. gather_bert is the inverse of
shard_bert (and of the pipeline's split of the layers): the full Flax
tree, for artifacts and best variables.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from mec_tpu_torch.parallel.mesh import MODEL_AXIS, DataMesh

Spec = Tuple[Optional[str], ...]
# (path-substring requirements, leaf-name, spec) — first match wins.
# Paths are '/'-joined Flax param tree keys, e.g.
# 'params/layer_3/attention_self/query/kernel'.
BertRules = Sequence[Tuple[Tuple[str, ...], str, Spec]]


def bert_partition_rules() -> BertRules:
    col = (None, MODEL_AXIS)   # (in, out) kernel, split output dim
    row = (MODEL_AXIS, None)   # (in, out) kernel, split input dim
    return (
        (('attention_self', 'query'), 'kernel', col),
        (('attention_self', 'key'), 'kernel', col),
        (('attention_self', 'value'), 'kernel', col),
        (('attention_self', 'query'), 'bias', (MODEL_AXIS,)),
        (('attention_self', 'key'), 'bias', (MODEL_AXIS,)),
        (('attention_self', 'value'), 'bias', (MODEL_AXIS,)),
        (('attention_output',), 'kernel', row),
        (('intermediate',), 'kernel', col),
        (('intermediate',), 'bias', (MODEL_AXIS,)),
        (('layer_', 'output'), 'kernel', row),
        # MoE expert bank: the leading expert dim shards over 'model';
        # the router stays replicated
        (('moe',), 'wi', (MODEL_AXIS, None, None)),
        (('moe',), 'wo', (MODEL_AXIS, None, None)),
        (('moe',), 'bi', (MODEL_AXIS, None)),
        (('moe',), 'bo', (MODEL_AXIS, None)),
    )


def partition_spec_for(path: Tuple[str, ...], rules: BertRules) -> Spec:
    joined = '/'.join(path)
    leaf = path[-1]
    for substrings, leaf_name, spec in rules:
        if leaf == leaf_name and all(s in joined for s in substrings):
            return spec
    return ()


# ----------------------------------------------------------------------
# the collectives, as autograd functions over the 'model' group
# ----------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, tp: 'TensorParallel') -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=tp.group)
    return t


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along dim (over gloo, through the
    host for a CUDA tensor)."""
    dev = t.device
    if dev.type == 'cuda' and dist.get_backend(group) == 'gloo':
        t = t.cpu()
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim).to(dev)


def _all_gather_seq(t: torch.Tensor, tp: 'TensorParallel') -> torch.Tensor:
    return _all_gather(t, tp.group, 1)


def _split_seq(t: torch.Tensor, tp: 'TensorParallel') -> torch.Tensor:
    return t.chunk(tp.size, dim=1)[tp.rank].contiguous()


def _reduce_scatter_seq(t: torch.Tensor, tp: 'TensorParallel'
                        ) -> torch.Tensor:
    if tp.nccl:
        parts = [c.contiguous() for c in t.chunk(tp.size, dim=1)]
        out = torch.empty_like(parts[tp.rank])
        dist.reduce_scatter(out, parts, group=tp.group)
        return out
    # gloo has no reduce-scatter: the sum, then this rank's part
    return _split_seq(_all_reduce(t, tp), tp)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along the sequence. Backward: reduce-scatter when the
    ranks' gradients of the whole sequence are partial sums (a sharded
    block follows), else this rank's part of the one gradient they all
    hold (a whole block follows)."""

    @staticmethod
    def forward(ctx, x, tp, partial):
        ctx.tp, ctx.partial = tp, partial
        return _all_gather_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter_seq(g, ctx.tp), None, None
        return _split_seq(g, ctx.tp), None, None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _split_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.tp), None


class _ReduceScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce_scatter_seq(x, tp)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_seq(g, ctx.tp), None


class TensorParallel:
    """This rank's place on the 'model' axis and the block boundaries of
    the Megatron pattern (seq: sequence parallelism)."""

    def __init__(self, mesh: DataMesh, seq: bool = False):
        self.size, self.rank = mesh.model, mesh.model_rank
        self.group, self.seq = mesh.model_group, seq
        self.nccl = dist.get_backend(self.group) == 'nccl'

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """copy-to-TP: identity forward, all-reduce backward."""
        return _CopyToTP.apply(x, self)

    def enter(self, h: torch.Tensor, sharded: bool) -> torch.Tensor:
        """A block's input from the residual stream: for a block that
        holds slices, copy-to-TP (SP: all-gather, reduce-scatter back);
        for a whole block, h (SP: all-gather, this rank's part back)."""
        if self.seq:
            return _GatherSeq.apply(h, self, sharded)
        return self.copy(h) if sharded else h

    def exit(self, y: torch.Tensor, sharded: bool) -> torch.Tensor:
        """A block's output to the residual stream: a sharded block's
        partial sum reduced (SP: reduce-scattered); a whole block's
        output as it is (SP: this rank's part)."""
        if self.seq:
            return (_ReduceScatterSeq.apply(y, self) if sharded
                    else _SplitSeq.apply(y, self))
        return _ReduceFromTP.apply(y, self) if sharded else y

    def scatter(self, h: torch.Tensor) -> torch.Tensor:
        """SP: the embeddings' whole (B, L, H) -> this rank's shard."""
        if not self.seq:
            return h
        if h.shape[1] % self.size:
            raise ValueError(f'sequence parallelism: length {h.shape[1]} '
                             f'does not split over {self.size} model ranks')
        return _SplitSeq.apply(h, self)

    def gather(self, h: torch.Tensor) -> torch.Tensor:
        """SP: the last hidden state's shard -> the whole sequence (the
        pooler reads position 0 on every rank)."""
        return _GatherSeq.apply(h, self, False) if self.seq else h


# ----------------------------------------------------------------------
# shard and gather the port's BERT
# ----------------------------------------------------------------------

def _keep(layer: nn.Module, name: str, dim: int, lo: int, hi: int,
          shards: Dict[str, int], prefix: str) -> None:
    """Replace parameter `name` of `layer` by its slice [lo, hi) along
    torch-layout dim `dim`, recording it in shards."""
    p = getattr(layer, name)
    setattr(layer, name, nn.Parameter(p.detach().narrow(dim, lo, hi - lo)
                                      .clone(), requires_grad=p.requires_grad))
    shards[f'{prefix}{name}'] = dim


def _axes(model: nn.Module) -> Dict[str, Tuple[tuple, tuple]]:
    axes = getattr(model, 'mec_axes', None)
    if axes is None:
        axes = model.mec_axes = {n: ((), ()) for n, _ in
                                 model.named_parameters()}
    return axes


def mark(model: nn.Module, name: str, sharded: tuple = (),
         partial: tuple = ()) -> None:
    """Add axes to parameter `name`'s (sharded over, partial over)."""
    axes = _axes(model)
    s, p = axes.get(name, ((), ()))
    axes[name] = (tuple(dict.fromkeys(s + sharded)),
                  tuple(dict.fromkeys(p + partial)))


# a layer's blocks, by the prefixes of their parameter names: each holds
# its slices only when every leaf the rules shard in it divides
_BLOCKS = (('attention', ('attention_self.', 'attention_output.')),
           ('ffn', ('intermediate.', 'output.')),
           ('moe', ('moe.',)))


def split_dim(model: nn.Module, name: str) -> Optional[int]:
    """The torch dimension of parameter `name` that bert_partition_rules
    shard over 'model', or None for a whole leaf. The rules read the
    Flax path of convert/to_jax.py's naming (a Dense's weight is its
    kernel, transposed)."""
    *mods, leaf = name.split('.')
    owner = model.get_submodule('.'.join(mods))
    kernel = isinstance(owner, nn.Linear) and leaf == 'weight'
    spec = partition_spec_for(('params', *mods, 'kernel' if kernel else leaf),
                              bert_partition_rules())
    if MODEL_AXIS not in spec:
        return None
    d = spec.index(MODEL_AXIS)
    return getattr(owner, leaf).dim() - 1 - d if kernel else d


def shard_bert(model: nn.Module, mesh: DataMesh,
               seq_parallel: bool = False) -> nn.Module:
    """Keep this 'model' rank's slices of a whole (Flax-initialised or
    loaded) BertForSequenceClassification, in place, as
    bert_partition_rules place them, and give its layers the
    TensorParallel that runs them. Every rank starts from the same whole
    module. Returns the module."""
    M, r = mesh.model, mesh.model_rank
    if M == 1:
        if seq_parallel:
            raise ValueError('sequence parallelism needs a model axis of '
                             'more than one rank')
        return model
    tp = TensorParallel(mesh, seq_parallel)
    model.tp = tp
    shards: Dict[str, int] = {}
    for name, _p in model.named_parameters():
        d = split_dim(model, name)
        if d is not None and not (name.startswith('layer_') and any(
                name.split('.', 1)[1].startswith(heads)
                for _b, prefixes in _BLOCKS for heads in prefixes)):
            raise ValueError(f'the rules shard {name}, which no tensor '
                             f'parallel block holds')
    for lname, layer in model.named_children():
        if not lname.startswith('layer_'):
            continue
        layer.tp = tp
        pre = f'{lname}.'
        dims = {n: split_dim(model, pre + n)
                for n, _p in layer.named_parameters()}
        for block, prefixes in _BLOCKS:
            leaves = {n: d for n, d in dims.items()
                      if d is not None and n.startswith(prefixes)}
            # JAX's per-leaf fallback (partition.py:85-108), a whole block
            # at a time; the attention splits by whole heads
            if not leaves or any(layer.get_parameter(n).shape[d] % M
                                 for n, d in leaves.items()) or (
                    block == 'attention'
                    and layer.attention_self.heads % M):
                continue
            for n, d in leaves.items():
                mod, leaf = n.rsplit('.', 1)
                w = layer.get_parameter(n).shape[d] // M
                _keep(layer.get_submodule(mod), leaf, d, r * w, (r + 1) * w,
                      shards, f'{pre}{mod}.')
            if block == 'attention':
                layer.attn_sharded = True
                layer.attention_self.heads //= M
            elif block == 'ffn':
                layer.ffn_sharded = True
            else:
                layer.moe.ep = tp
                layer.moe.expert_offset = r * layer.moe.wi.shape[0]
        if seq_parallel:
            # the residual stream's shard: its norms and the row biases
            # added on it see this rank's positions only
            partial = [f'{pre}{n}.{leaf}' for n in ('attention_norm',
                                                     'output_norm')
                       for leaf in ('weight', 'bias')]
            if layer.attn_sharded:
                partial.append(f'{pre}attention_output.bias')
            if layer.ffn_sharded:
                partial.append(f'{pre}output.bias')
            for n in partial:
                mark(model, n, partial=(MODEL_AXIS,))
    for n in shards:
        mark(model, n, sharded=(MODEL_AXIS,))
    model.mec_shards = shards
    model.mec_mesh = mesh
    return model


def gather_state(model: nn.Module, tensors: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """tensors (keyed by this rank's parameter and buffer names: its
    state dict, or its gradients) -> the whole model's, on the CPU, on
    every rank: the model axis's slices concatenated, the pipe axis's
    layers collected. A collective over the model and pipe groups."""
    mesh: Optional[DataMesh] = getattr(model, 'mec_mesh', None)
    out = {k: v.detach() for k, v in tensors.items()}
    if mesh is None:
        return {k: v.cpu() for k, v in out.items()}
    if mesh.model > 1:
        shards = model.mec_shards
        out = {k: (_all_gather(v, mesh.model_group, shards[k])
                   if k in shards else v) for k, v in out.items()}
    out = {k: v.cpu() for k, v in out.items()}
    if mesh.pipe > 1:
        from mec_tpu_torch.parallel.pipeline import gather_stages
        out = gather_stages(model, out, mesh)
    return out


def whole_model(model: nn.Module) -> nn.Module:
    """A whole float32 BertForSequenceClassification on the CPU holding
    the gathered state of this (sharded) one."""
    from mec_tpu_torch.models.bert import BertForSequenceClassification
    full = BertForSequenceClassification(**model.config)
    state = gather_state(model, model.state_dict())
    full.load_state_dict({k: v.to(full.state_dict()[k].dtype)
                          for k, v in state.items()})
    return full


def gather_bert(model: nn.Module) -> Dict[str, Any]:
    """The whole model's Flax tree ({'params'}), on every rank (the
    artifacts are written by rank 0)."""
    from mec_tpu_torch.convert.to_jax import to_jax
    return to_jax(whole_model(model))


__all__ = ['bert_partition_rules', 'partition_spec_for', 'TensorParallel',
           'split_dim', 'shard_bert', 'gather_state', 'gather_bert',
           'whole_model', 'mark']
