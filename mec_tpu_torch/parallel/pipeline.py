"""GPipe pipeline parallelism for the BERT encoder over the mesh's
'pipe' axis: the port of mec_tpu/parallel/pipeline.py.

JAX stacks the encoder layers on a leading axis sharded over 'pipe' and
runs a shard_map-ed schedule whose transpose is the backward. Here each
pipe rank (stage s of S) keeps layers [s*N/S, (s+1)*N/S) of the port's
BertForSequenceClassification (split_stages; N % S raises) and the
schedule is written by hand:

  * the rank's rows (its data shard) pad to a multiple of the
    microbatch count M with rows that attend only the CLS position (an
    all-zero mask is NaN in bf16; JAX pipeline.py:256-262) and split
    into M microbatches;
  * forward: stage 0 embeds each microbatch (embedding dropout, JAX's
    site 0), every stage runs its layers (each recomputed in the
    backward pass under torch.utils.checkpoint when remat, JAX's
    default) and sends the result to the next stage; the last stage
    applies the pooler (pooled dropout, site 1) and classifier and keeps
    each microbatch's share of the mean cross-entropy;
  * backward, microbatches in reverse: the last stage differentiates its
    share, every stage sends its input's gradient to the previous one,
    which receives it as its output's;
  * the loss and, in eval, the logits are broadcast from the last stage
    to the pipe group, so every rank of the mesh sees them.

Point-to-point transfers go to the global ranks of the neighbouring
stages (rank = (d * model + m) * pipe + p: the adjacent ranks); over
gloo, which sends CPU tensors only, a CUDA tensor goes through the
host. With a 'model' axis too, each stage's layers run their tensor
parallel forward (parallel/partition.shard_bert: JAX's
tp_bert_layer_apply), which makes DP x TP x PP. The embeddings, pooler
and classifier live on every stage and take gradients on the first or
last only: marked partial over 'pipe' in model.mec_axes, so the fit
sums them over the pipe group before the clip (JAX's psum). The stage
layers are marked sharded over 'pipe'.

stack_layer_params / unstack_layer_params are JAX's, on Flax numpy
trees; gather_stages (partition.gather_state's pipe step) moves the
stages' layers as JAX keeps them, the stacked bank sharded over 'pipe'.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mec_tpu_torch.models.batchnorm import remat as remat_layer
from mec_tpu_torch.models.batchnorm import wide
from mec_tpu_torch.parallel.mesh import PIPE_AXIS, DataMesh
from mec_tpu_torch.parallel.partition import mark


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_params(params: dict, num_layers: int,
                       prefix: str = 'layer_') -> Any:
    """Stack params[f'{prefix}i'] for i in [0, num_layers) on a new
    leading axis."""
    layers = [params[f'{prefix}{i}'] for i in range(num_layers)]
    return _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                     *layers)


def unstack_layer_params(stacked: Any, prefix: str = 'layer_') -> dict:
    """Inverse of stack_layer_params (the canonical Flax layout)."""
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return {f'{prefix}{i}': _tree_map(lambda x, i=i: x[i], stacked)
            for i in range(np.shape(leaf)[0])}


def stage_layers(num_layers: int, stages: int, stage: int) -> range:
    if num_layers % stages:
        raise ValueError(f'{num_layers} layers do not split over '
                         f'{stages} pipeline stages')
    per = num_layers // stages
    return range(stage * per, (stage + 1) * per)


def split_stages(model: nn.Module, mesh: DataMesh) -> nn.Module:
    """Keep this pipe rank's layers of the model, in place (the others
    removed), and mark the parameters' axes. Returns the module."""
    if mesh.pipe == 1:
        return model
    if model.num_experts > 0:
        raise ValueError('the pipeline stage runs dense-FFN layers only')
    keep = stage_layers(model.num_layers, mesh.pipe, mesh.pipe_rank)
    for i in range(model.num_layers):
        if i not in keep:
            del model._modules[f'layer_{i}']
    model.stage = keep
    model.mec_mesh = mesh
    for name, _p in model.named_parameters():
        if name.startswith('layer_'):
            mark(model, name, sharded=(PIPE_AXIS,))
        else:
            mark(model, name, partial=(PIPE_AXIS,))
    return model


def gather_stages(model: nn.Module, tensors: Dict[str, torch.Tensor],
                  mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """This stage's CPU tensors (keyed by parameter or buffer name) ->
    the whole model's, on every pipe rank. As in JAX, the layers travel
    as the stage's block of the stacked layer bank (stack_layer_params
    over its layers, the leading axis the one sharded over 'pipe'),
    gathered along that axis and unstacked to one entry a layer; the
    other entries are the first stage's (every stage holds them)."""
    first = model.stage.start
    layers: Dict[str, Dict[str, np.ndarray]] = {}
    rest = {}
    for k, v in tensors.items():
        if k.startswith('layer_'):
            head, leaf = k.split('.', 1)
            i = int(head[len('layer_'):]) - first
            layers.setdefault(f'layer_{i}', {})[leaf] = v.numpy()
        else:
            rest[k] = v
    stages = [None] * mesh.pipe
    dist.all_gather_object(
        stages, (stack_layer_params(layers, len(layers)), rest),
        group=mesh.pipe_group)
    bank = _tree_map(lambda *xs: np.concatenate(xs),
                     *(st[0] for st in stages))
    out = dict(stages[0][1])
    for name, leaves in unstack_layer_params(bank).items():
        out.update({f'{name}.{leaf}': torch.from_numpy(x.copy())
                    for leaf, x in leaves.items()})
    return out


def _embed(model: nn.Module, ids: torch.Tensor) -> torch.Tensor:
    """The model's embeddings, LayerNorm and embedding dropout."""
    ids = ids.long()
    pos = torch.arange(ids.shape[1], device=ids.device)
    h = (model.word_embeddings(ids) + model.position_embeddings(pos)[None]
         + model.token_type_embeddings(torch.zeros_like(ids)))
    return model.dropout(model.embeddings_norm(h))


def _head(model: nn.Module, h: torch.Tensor) -> torch.Tensor:
    pooled = model.dropout(torch.tanh(model.pooler(h[:, 0, :])))
    return wide(model.classifier(pooled))


class _P2P:
    """Sends and receives between stages (over gloo, through the host)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = dist.get_backend() == 'gloo' and device.type == 'cuda'

    def send(self, t: torch.Tensor, dst: int) -> None:
        t = t.detach().contiguous()
        dist.send(t.cpu() if self.host else t, dst)

    def recv(self, shape, dtype, src: int) -> torch.Tensor:
        buf = torch.empty(shape, dtype=dtype,
                          device='cpu' if self.host else self.device)
        dist.recv(buf, src)
        return buf.to(self.device)


def pad_rows(ids: torch.Tensor, mask: torch.Tensor, multiple: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad to a multiple of `multiple` rows; the pad rows attend only
    the CLS position."""
    pad = (-ids.shape[0]) % multiple
    if not pad:
        return ids, mask
    L = ids.shape[1]
    pad_mask = torch.zeros((pad, L), dtype=mask.dtype, device=mask.device)
    pad_mask[:, 0] = 1
    return (torch.cat([ids, ids.new_zeros((pad, L))]),
            torch.cat([mask, pad_mask]))


def pipeline_step(model: nn.Module, batch: Dict[str, torch.Tensor],
                  mesh: DataMesh, num_microbatches: int = 2, *,
                  train: bool = False, remat: bool = True,
                  bf16: bool = False) -> torch.Tensor:
    """One pass of the GPipe schedule over this rank's rows. train: the
    forward and backward (the parameters' .grad accumulate this rank's
    shares) -> the mean cross-entropy over the rows; else the forward
    -> the logits (rows, C) in fp32. Both on every rank of the pipe
    group."""
    S, s, M = mesh.pipe, mesh.pipe_rank, int(num_microbatches)
    ids, mask = batch['ids'], batch['mask']
    n = ids.shape[0]
    ids, mask = pad_rows(ids, mask, M)
    mb = ids.shape[0] // M
    dev = ids.device
    dtype = model.embeddings_norm.dtype
    bias = ((1.0 - mask.float()) * model.neg).to(model.dtype)
    prev = mesh.global_of(mesh.rank, mesh.model_rank, s - 1)
    nxt = mesh.global_of(mesh.rank, mesh.model_rank, s + 1)
    last = mesh.global_of(mesh.rank, mesh.model_rank, S - 1)
    p2p = _P2P(dev)
    layers = [getattr(model, f'layer_{i}') for i in model.stage]
    shape = (mb, ids.shape[1], model.embeddings_norm.weight.shape[0])

    def run(x, b):
        with torch.autocast(dev.type, torch.bfloat16, enabled=bf16):
            for layer in layers:
                x = (remat_layer(layer, x, b) if remat and train
                     else layer(x, b))
        return x

    ins: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    shares: List[torch.Tensor] = []
    grad = torch.enable_grad() if train else torch.no_grad()
    with grad:
        for k in range(M):
            rows = slice(k * mb, (k + 1) * mb)
            if s == 0:
                with torch.autocast(dev.type, torch.bfloat16, enabled=bf16):
                    x = _embed(model, ids[rows])
            else:
                x = p2p.recv(shape, dtype, prev).requires_grad_(train)
            y = run(x, bias[rows])
            ins.append(x)
            outs.append(y)
            if s < S - 1:
                p2p.send(y, nxt)
                continue
            with torch.autocast(dev.type, torch.bfloat16, enabled=bf16):
                logits = _head(model, y)
            if not train:
                shares.append(logits)
                continue
            real = max(0, min(mb, n - k * mb))
            labels = batch['label'][k * mb:k * mb + real].long()
            logp = F.log_softmax(wide(logits[:real]), dim=-1)
            shares.append(-logp.gather(1, labels[:, None]).sum() / n)
    # the logits' and the loss's dtype: fp32, or float64 for a float64
    # model (models.batchnorm.wide)
    wide_dtype = wide(model.classifier.weight[:0, 0]).dtype
    if not train:
        out = (torch.cat(shares) if s == S - 1 else torch.empty(
            (ids.shape[0], model.classifier.weight.shape[0]),
            dtype=wide_dtype, device=dev))
        dist.broadcast(out, src=last, group=mesh.pipe_group)
        return out[:n]
    for k in reversed(range(M)):
        if s == S - 1:
            shares[k].backward()
        else:
            torch.autograd.backward(outs[k], p2p.recv(shape, dtype, nxt))
        if s > 0:
            p2p.send(ins[k].grad, prev)
    loss = (torch.stack([t.detach() for t in shares]).sum() if s == S - 1
            else torch.zeros((), dtype=wide_dtype, device=dev))
    dist.broadcast(loss, src=last, group=mesh.pipe_group)
    return loss


def make_pipeline_steps(model: nn.Module, mesh: DataMesh,
                        num_microbatches: int = 2, bf16: bool = False,
                        remat: bool = True) -> Tuple[Callable, Callable]:
    """Pipeline-parallel drop-in for train_text_bert.make_steps (JAX
    pipeline.py:323-360): train_step(state, batch) -> loss after one
    update, eval_step(state, batch) -> logits."""

    def train_step(state, batch):
        loss = pipeline_step(model, batch, mesh, num_microbatches,
                             train=True, remat=remat, bf16=bf16)
        state.apply_gradients()
        return loss

    def eval_step(state, batch):
        return pipeline_step(model, batch, mesh, num_microbatches,
                             bf16=bf16)

    return train_step, eval_step
