"""Shared training machinery: the train state, the optimizers, the fit loop.

The port of mec_tpu/training/common.py. Host-side control (early
stopping, LR on plateau, best-variables selection, a checkpoint before
the stop is honoured, resume, epoch_transform, on_epoch_end) is the JAX
fit's, line for line; the device work is one eager step a batch on the
module's device. Not ported: the lax.scan epoch paths (a TPU dispatch
workaround; one per-step loop replaces them, with the same batch order
and the same ragged tail). record_metrics writes each trainer's
validation metrics into the model_metrics table through the port's
database/ (best effort, as in JAX).

The optimizers are optax's, written over torch tensors and pinned to
optax by tests/test_torch_train_optim.py:

  * adam_with_clip / adamw_with_clip: optax.chain(clip_by_global_norm,
    inject_hyperparams(adam|adamw)), lr a float or a schedule of the
    update count (linear_schedule, cosine_decay_schedule,
    join_schedules, evaluated in float32 as optax does);
  * Tx(groups, label=...): optax.multi_transform after the clip, so
    every group's gradients count in the global norm (a group None is
    optax.set_to_zero: its gradients are computed and not applied);
  * multi_steps(tx, k): optax.MultiSteps, a running mean of k
    micro-gradients and one update on every k-th call.

The clip is optax's (g / norm * max when norm >= max), not
clip_grad_norm_'s (max / (norm + 1e-6)); AdamW decays every parameter,
biases and norms too, as optax's default mask and one torch group do.

Randomness is derived per (seed, epoch, step), so a resumed epoch draws
what an uninterrupted run draws: the shuffle is
np.random.RandomState((seed * 1000003 + epoch) % 2**32), the JAX
stream, so the batch order equals JAX's; dropout uses the default
generators, forked and seeded per step (torch.random.fork_rng), which
also lets torch.utils.checkpoint replay the same masks under remat.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mec_tpu_torch.models.batchnorm import wide
from mec_tpu_torch.models.bert import LayerNorm
from mec_tpu_torch.models.fusion import TorchMultiheadAttention
from mec_tpu_torch.models.moe import MoEFFN
from mec_tpu_torch.parallel import mesh as pmesh

Schedule = Callable[[int], float]


# ----------------------------------------------------------------------
# schedules: optax's, as functions of the update count
# ----------------------------------------------------------------------

def _f32(x) -> float:
    return float(np.float32(x))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule (transition_begin 0)."""
    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return _f32(init_value)
        c = np.clip(np.float32(count), 0, transition_steps)
        frac = np.float32(1) - c / np.float32(transition_steps)
        return _f32((np.float32(init_value) - np.float32(end_value)) * frac
                    + np.float32(end_value))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule (exponent 1)."""
    def schedule(count: int) -> float:
        c = np.minimum(np.float32(count), np.float32(decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(np.pi) * c / np.float32(decay_steps),
            dtype=np.float32))
        decayed = (np.float32(1) - np.float32(alpha)) * cosine \
            + np.float32(alpha)
        return _f32(np.float32(init_value) * decayed)
    return schedule


def join_schedules(schedules: List[Schedule], boundaries: List[int]
                   ) -> Schedule:
    """optax.join_schedules: schedule i from boundary i-1, counted from
    that boundary."""
    def schedule(count: int) -> float:
        for s, b in zip(schedules[:-1], boundaries):
            if count < b:
                break
        else:
            s = schedules[-1]
        start = max([0] + [b for b in boundaries if b <= count])
        return s(count - start)
    return schedule


# ----------------------------------------------------------------------
# optimizers: optax's, over torch tensors
# ----------------------------------------------------------------------

B1, B2, EPS = 0.9, 0.999, 1e-8      # optax's Adam defaults


class Adam:
    """optax.adam (weight_decay None) or optax.adamw (decoupled decay
    on every parameter) with optax's b1, b2 and eps. inject: under
    optax.inject_hyperparams, so get_lr reads the rate and set_lr
    changes it (a schedule still sets it anew at every update)."""

    def __init__(self, learning_rate, weight_decay: Optional[float] = None,
                 inject: bool = True):
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.inject = inject

    def rate(self, count: int) -> float:
        lr = self.learning_rate
        return lr(count) if callable(lr) else _f32(lr)

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        state = {'count': 0, 'mu': [torch.zeros_like(p) for p in params],
                 'nu': [torch.zeros_like(p) for p in params]}
        if self.inject:
            state['lr'] = self.rate(0)
        return state

    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The updates (-lr * step); state advances in place."""
        count = state['count']
        lr = (state['lr'] if self.inject and not callable(self.learning_rate)
              else self.rate(count))
        mu, nu = state['mu'], state['nu']
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
        c = np.float32(count + 1)
        bc1 = _f32(np.float32(1) - np.float32(B1) ** c)
        bc2 = _f32(np.float32(1) - np.float32(B2) ** c)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -lr)
        state['count'] = count + 1
        if self.inject:
            state['lr'] = lr
        return upd


class Tx:
    """optax.chain(clip_by_global_norm(clipnorm), multi_transform(groups,
    label)), optionally under MultiSteps(every_k). groups maps a label
    to an Adam, or to None for optax.set_to_zero; label(name) gives a
    parameter's group (one group: label None)."""

    def __init__(self, groups: Dict[str, Optional[Adam]],
                 label: Optional[Callable[[str], str]] = None,
                 clipnorm: float = 1.0, every_k: int = 1):
        self.groups, self.label = groups, label
        self.clipnorm, self.every_k = clipnorm, max(1, int(every_k))

    def _group_of(self, name: str) -> str:
        return self.label(name) if self.label else next(iter(self.groups))

    def init(self, names: List[str], params: List[torch.Tensor]
             ) -> Dict[str, Any]:
        state: Dict[str, Any] = {'groups': {}}
        for g, opt in self.groups.items():
            idx = [i for i, n in enumerate(names) if self._group_of(n) == g]
            state['groups'][g] = {'index': idx}
            if opt is not None:
                state['groups'][g].update(opt.init([params[i] for i in idx]))
        if self.every_k > 1:
            state.update(mini_step=0,
                         acc=[torch.zeros_like(p) for p in params])
        return state

    def _clip(self, grads: List[torch.Tensor],
              norm_fn: Optional[Callable] = None) -> List[torch.Tensor]:
        norm = (norm_fn or global_norm)(grads)
        scale = torch.where(norm < self.clipnorm, torch.ones_like(norm),
                            self.clipnorm / norm)
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: Dict[str, Any],
             params: List[torch.Tensor],
             norm_fn: Optional[Callable] = None) -> None:
        """One update of params in place (under MultiSteps: one
        micro-step, applying the mean on every k-th). norm_fn(grads): the
        clip's global norm, where the tree is sharded over ranks."""
        if self.every_k > 1:
            n = state['mini_step']
            acc = state['acc']
            diff = torch._foreach_sub(grads, acc)
            torch._foreach_div_(diff, float(n + 1))
            torch._foreach_add_(acc, diff)
            if n < self.every_k - 1:
                state['mini_step'] = n + 1
                return
            grads = acc
            state.update(mini_step=0,
                         acc=[torch.zeros_like(a) for a in acc])
        grads = self._clip(grads, norm_fn)
        for g, opt in self.groups.items():
            if opt is None:
                continue
            gs = state['groups'][g]
            idx = gs['index']
            sub = [params[i] for i in idx]
            upd = opt.update([grads[i] for i in idx], gs, sub)
            torch._foreach_add_(sub, upd)


def adam_with_clip(lr, clipnorm: float = 1.0) -> Tx:
    """Adam + global-norm clip, LR exposed for plateau reduction
    (reference Keras `Adam(1e-3, clipnorm=1.0)`)."""
    return Tx({'all': Adam(lr)}, clipnorm=clipnorm)


def adamw_with_clip(lr, weight_decay: float = 0.01, clipnorm: float = 1.0
                    ) -> Tx:
    """AdamW + clip; `lr` may be a float or a schedule."""
    return Tx({'all': Adam(lr, weight_decay)}, clipnorm=clipnorm)


def multi_steps(tx: Tx, every_k: int) -> Tx:
    """optax.MultiSteps(tx, every_k_schedule=every_k)."""
    return Tx(tx.groups, tx.label, tx.clipnorm, every_k)


def optimizer_total_steps(n_rows: int, batch_size: int, epochs: int,
                          grad_accum: int = 1) -> int:
    """Number of optimizer updates fit() performs over a run: micro-steps
    ceil-counted (the ragged tail trains too), divided by grad_accum once
    over the run, since accumulation windows span epochs."""
    micro_per_epoch = max(1, -(-int(n_rows) // int(batch_size)))
    return max(1, (micro_per_epoch * int(epochs)) // max(1, int(grad_accum)))


# ----------------------------------------------------------------------
# train state
# ----------------------------------------------------------------------

class TrainState:
    """The module (its parameters and, as buffers, its batch statistics),
    the optimizer and its state, and the update step. Parameters that
    take no gradient (a Bi-LSTM's bias_hh) are not optimized."""

    def __init__(self, model: nn.Module, tx: Tx):
        self.model, self.tx = model, tx
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.opt_state = tx.init(self.names, self.params)
        self.step = 0

    @property
    def device(self) -> torch.device:
        return self.params[0].device

    def apply_gradients(self) -> None:
        """One optimizer call on the parameters' .grad, which it clears.
        Inside a data-parallel fit the gradients are first averaged over
        the data ranks (one all-reduce a dtype), so the clip's global norm
        is the global gradient's, as in JAX. On a mesh with model or pipe
        ranks (the module's mec_axes, parallel/partition.py and
        pipeline.py), the gradients that are partial sums over an axis
        are summed over it too, and the clip's norm counts each sharded
        leaf once over its axes and each whole leaf once: the norm of
        the full tree."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        dmesh = pmesh.active()
        norm_fn = None
        if dmesh is not None:
            dmesh.all_reduce_(grads, mean=True)
            axes = getattr(self.model, 'mec_axes', None)
            if axes:
                kinds = [axes.get(n, ((), ())) for n in self.names]
                for axis in (pmesh.MODEL_AXIS, pmesh.PIPE_AXIS):
                    part = [g for g, (_s, p) in zip(grads, kinds) if axis in p]
                    if part:
                        dmesh.all_reduce_(part, axis=axis)
                norm_fn = sharded_norm(dmesh, [s for s, _p in kinds])
        self.tx.step(grads, self.opt_state, self.params, norm_fn)
        for p in self.params:
            p.grad = None
        self.step += 1

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """A CPU copy of the module's state dict."""
        return {k: v.detach().to('cpu', copy=True)
                for k, v in self.model.state_dict().items()}


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the norm of the whole tree."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def sharded_norm(mesh: pmesh.DataMesh, sharded: List[tuple]) -> Callable:
    """norm_fn for Tx.step: the global norm of a tree whose leaf i is
    sharded over the axes sharded[i] (its squares summed over them) and
    whole elsewhere (counted once)."""
    def norm(grads: List[torch.Tensor]) -> torch.Tensor:
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        m = torch.tensor([pmesh.MODEL_AXIS in s for s in sharded],
                         device=sq.device)
        p = torch.tensor([pmesh.PIPE_AXIS in s for s in sharded],
                         device=sq.device)
        zero = torch.zeros((), dtype=sq.dtype, device=sq.device)
        # [model only, model and pipe], summed over 'model'; then
        # [pipe only, model and pipe summed], over 'pipe'
        by_m = torch.stack([torch.where(m & ~p, sq, zero).sum(),
                            torch.where(m & p, sq, zero).sum()])
        mesh.all_reduce_([by_m], axis=pmesh.MODEL_AXIS)
        by_p = torch.stack([torch.where(~m & p, sq, zero).sum()
                                  + by_m[1]])
        mesh.all_reduce_([by_p], axis=pmesh.PIPE_AXIS)
        return torch.sqrt(torch.where(~m & ~p, sq, zero).sum() + by_m[0]
                          + by_p[0])
    return norm


def _injected(state: TrainState) -> List[Dict[str, Any]]:
    return [state.opt_state['groups'][g]
            for g, opt in state.tx.groups.items()
            if opt is not None and opt.inject]


def get_lr(state: TrainState) -> float:
    """The injected learning rate (the last update's; nan when no group
    injects one, as optax's get_lr over a multi_transform)."""
    for gs in _injected(state):
        return float(gs['lr'])
    return float('nan')


def set_lr(state: TrainState, lr: float) -> TrainState:
    for gs in _injected(state):
        gs['lr'] = _f32(lr)
    return state


def softmax_cross_entropy(logits: torch.Tensor, onehot: torch.Tensor
                          ) -> torch.Tensor:
    logp = F.log_softmax(wide(logits), dim=-1)
    return -(onehot * logp).sum(dim=-1).mean()


def iterate_batches(data: Dict[str, np.ndarray], batch_size: int,
                    rng: np.random.RandomState, shuffle: bool = True,
                    drop_remainder: bool = False
                    ) -> Iterator[Dict[str, np.ndarray]]:
    n = len(next(iter(data.values())))
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    stop = n - (n % batch_size) if drop_remainder else n
    for s in range(0, stop, batch_size):
        sel = idx[s:s + batch_size]
        yield {k: v[sel] for k, v in data.items()}


def pad_batch(batch: Dict[str, np.ndarray], batch_size: int
              ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad a ragged tail batch up to `batch_size` by repeating its last
    row; returns (batch, true rows)."""
    n = len(next(iter(batch.values())))
    if n == batch_size:
        return batch, n
    pad = batch_size - n
    return ({k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
             for k, v in batch.items()}, n)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def step_seed(seed: int, epoch: int, step: int, rank: int = 0) -> int:
    """The dropout seed of one (seed, epoch, step) on one data rank."""
    entropy = [seed, epoch, step] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy)
               .generate_state(1, np.uint32)[0])


def resolve_device(device) -> torch.device:
    """The trainers' device: 'cuda' needs a card and never falls back;
    without an index it is the current card (a rank's own)."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev}')
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def add_device_flag(parser) -> None:
    parser.add_argument('--device', default='cuda',
                        help="torch device to train on (default cuda; "
                             "'cpu' for tests and small runs)")


def train_mesh(mesh_data: int, mesh_model: int = 0, mesh_pipe: int = 0
               ) -> Optional[pmesh.DataMesh]:
    """The BERT trainer's --mesh-data, --mesh-model and --mesh-pipe: None
    when each is 0 or 1, else the (data, model, pipe) mesh of the
    initialized process group, which must hold exactly their product of
    ranks (parallel/mesh.make_mesh raises otherwise)."""
    sizes = [max(1, int(n or 0)) for n in (mesh_data, mesh_model, mesh_pipe)]
    return pmesh.make_mesh(*sizes) if max(sizes) > 1 else None


def data_mesh(mesh_data: int) -> Optional[pmesh.DataMesh]:
    """The trainers' --mesh-data: None for 0 or 1, else the data axis of
    the initialized process group, which must hold exactly mesh_data
    ranks (parallel/mesh.make_mesh raises otherwise: never a silent run
    on one device)."""
    return pmesh.make_mesh(mesh_data) if mesh_data and mesh_data > 1 \
        else None


def writes(mesh: Optional[pmesh.DataMesh]) -> bool:
    """Whether this process logs and writes files: global rank 0, or the
    only process."""
    return mesh is None or mesh.global_rank == 0


def barrier(mesh: Optional[pmesh.DataMesh]) -> None:
    if mesh is not None:
        mesh.barrier()


def logger(verbose: bool, mesh: Optional[pmesh.DataMesh] = None):
    """print on the writing rank when verbose, else a no-op."""
    return print if verbose and writes(mesh) else (lambda *_a, **_k: None)


def flax_init(model: nn.Module, seed: int) -> nn.Module:
    """Re-initialise `model` with Flax's initialisers (their
    distributions, not their random stream): lecun_normal Dense and conv
    kernels with zero biases, Flax Embed's normal(1/sqrt(features)),
    xavier_uniform LSTM input kernels, orthogonal recurrent kernels and
    zero biases, xavier_uniform MHA in-projections, norms at one and
    zero with running statistics at zero and one."""
    g = torch.Generator().manual_seed(seed)

    def lecun(w: torch.Tensor, fan_in: Optional[int] = None) -> None:
        fan_in = fan_in or w[0].numel()
        std = math.sqrt(1.0 / fan_in) / .87962566103423978
        w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, std,
                                      -2 * std, 2 * std, generator=g))

    def fill(w: torch.Tensor, init, *args) -> None:
        w.copy_(init(torch.empty(w.shape), *args, generator=g))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.LSTM):
                for name, p in m.named_parameters():
                    if name.startswith('weight_ih'):
                        fill(p, nn.init.xavier_uniform_)
                    elif name.startswith('weight_hh'):
                        fill(p, nn.init.orthogonal_)
                    else:
                        p.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun(m.weight)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                fill(m.weight, nn.init.normal_, 0.0,
                     1.0 / math.sqrt(m.weight.shape[1]))
            elif isinstance(m, MoEFFN):
                # Flax's fan-in of an (E, in, out) kernel: E * in
                lecun(m.wi, m.wi.shape[0] * m.wi.shape[1])
                lecun(m.wo, m.wo.shape[0] * m.wo.shape[1])
                m.bi.zero_()
                m.bo.zero_()
            elif isinstance(m, TorchMultiheadAttention):
                fill(m.in_proj_weight, nn.init.xavier_uniform_)
                m.in_proj_bias.zero_()
            elif isinstance(m, (LayerNorm, nn.modules.batchnorm._BatchNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
    return model


# ----------------------------------------------------------------------
# the fit loop
# ----------------------------------------------------------------------

def _rank_path(path: str, mesh: Optional[pmesh.DataMesh]) -> str:
    """The checkpoint of this rank's shard: `path` itself, or with model
    or pipe ranks holding other shards, `path`.m<m>p<p> beside it for
    all but the first (each written by its data rank 0)."""
    if mesh is None or (mesh.model_rank == 0 and mesh.pipe_rank == 0):
        return path
    return f'{path}.m{mesh.model_rank}p{mesh.pipe_rank}'


def record_metrics(model_name: str, val_acc: float,
                   y_true=None, y_pred=None) -> None:
    """Best-effort accuracy/F1 logging into the model_metrics table
    (mec_tpu/training/common.py:163-185; the reference defines the table
    but never writes it, reference database/db_operations.py:75-84)."""
    try:
        from mec_tpu_torch.database import get_db
        from mec_tpu_torch.training import metrics as m
        f1 = precision = recall = None
        if y_true is not None and y_pred is not None and len(y_true):
            pr = m.precision_recall_f1(np.asarray(y_true),
                                       np.asarray(y_pred),
                                       int(max(np.max(y_true), 6)) + 1)
            precision = float(pr['precision'].mean())
            recall = float(pr['recall'].mean())
            f1 = float(pr['f1'].mean())
        get_db().record_model_metric(model_name, accuracy=float(val_acc),
                                     precision_score=precision,
                                     recall_score=recall, f1_score=f1)
    except Exception:
        pass


def fit(state: TrainState,
        train_data: Dict[str, np.ndarray],
        val_data: Dict[str, np.ndarray],
        train_step: Callable,
        eval_step: Callable,
        *,
        epochs: int,
        batch_size: int,
        seed: int = 0,
        monitor: str = 'val_acc',
        patience: Optional[int] = None,
        min_delta: float = 0.0,
        reduce_lr_factor: Optional[float] = None,
        reduce_lr_patience: int = 10,
        min_lr: float = 1e-6,
        log_fn: Callable[[str], None] = print,
        on_epoch_end: Optional[Callable] = None,
        checkpoint_path: Optional[str] = None,
        resume: bool = False,
        epoch_transform: Optional[Callable] = None,
        mesh: Optional[pmesh.DataMesh] = None,
        ) -> Tuple[TrainState, Dict[str, torch.Tensor], Dict[str, list]]:
    """Epoch loop with early stopping and LR on plateau (JAX
    common.fit). train_step(state, batch) -> loss tensor, with batch a
    dict of tensors on the state's device and the module in training
    mode; it updates state in place. eval_step(state, batch) -> logits
    (or log-probabilities), the module in eval mode under no_grad.

    checkpoint_path: a full checkpoint after every epoch
    (training/checkpoint.py); resume=True restores state, epoch,
    history, best variables and the callback counters from it.
    epoch_transform(epoch, train_data) -> train_data re-draws
    augmentation each epoch. Every batch trains at its true shape (the
    ragged tail too); validation batches are padded with pad_batch.

    mesh (parallel/mesh.make_mesh): data parallelism over its ranks, as
    the JAX fit under a mesh. The module is broadcast from rank 0; every
    rank draws the same batch order, pads each batch to batch_size
    (the ragged tail too, as JAX pads under a mesh) and trains its rows
    of it inside parallel/mesh.data_parallel (BatchNorm statistics, the
    MoE aux loss and the gradients are the global batch's); dropout is
    seeded per (seed, epoch, step, rank). Validation is sharded the same
    way and its loss sum, hits and count are summed over the ranks, so
    every rank takes the same early-stop, plateau and best-variables
    decisions. Only rank 0 logs and writes the checkpoint (then all
    wait); every rank restores on resume. batch_size must divide by the
    number of data ranks. (Dropout masks never match JAX's, with or
    without a mesh: the two packages draw from different generators.)
    With model or pipe ranks (a module sharded by
    parallel/partition.shard_bert or split by pipeline.split_stages),
    the ranks of one data rank train the same rows and draw the same
    dropout masks (the seed names the data rank only: the dropouts sit
    where the hidden state is whole), the broadcast and the sums run
    over the data axis, the gradients that are partial sums over an axis
    are summed over it and the clip's norm is the full tree's
    (TrainState.apply_gradients); each model-and-pipe place's data rank
    0 writes its own shard's checkpoint (_rank_path), and the logits
    eval_step returns are the same on all of them.

    Returns (state, best_vars, history); best_vars is a CPU state dict.
    """
    from mec_tpu_torch.training import checkpoint as ckpt
    history: Dict[str, list] = {'loss': [], 'val_loss': [], 'val_acc': [],
                                'lr': []}
    best_metric = -np.inf
    best_vars = state.variables
    best_epoch = -1
    plateau_wait = 0
    stop_wait = 0
    start_epoch = 0
    device = state.device
    fork_devices = [device] if device.type == 'cuda' else []
    rank = 0
    if mesh is not None:
        if batch_size % mesh.size:
            raise ValueError(f'batch_size {batch_size} does not split over '
                             f'{mesh.size} data ranks')
        mesh.broadcast_module(state.model)
        rank = mesh.rank
        if not writes(mesh):
            log_fn = lambda *_a, **_k: None  # noqa: E731

    if checkpoint_path and resume and os.path.exists(
            _rank_path(checkpoint_path, mesh)):
        state, extra = ckpt.restore_train_state(
            _rank_path(checkpoint_path, mesh), state)
        start_epoch = int(extra.get('epoch', -1)) + 1
        history = {k: list(v) for k, v in
                   extra.get('history', history).items()}
        best_metric = float(extra.get('best_metric', best_metric))
        if extra.get('best_vars') is not None:
            best_vars = {k: torch.from_numpy(np.asarray(v))
                         for k, v in extra['best_vars'].items()}
        best_epoch = int(extra.get('best_epoch', best_epoch))
        plateau_wait = int(extra.get('plateau_wait', 0))
        stop_wait = int(extra.get('stop_wait', 0))
        log_fn(f'Resumed from {checkpoint_path} at epoch {start_epoch}')

    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        ep_rng = np.random.RandomState((seed * 1000003 + epoch) % 2**32)
        ep_data = (epoch_transform(epoch, train_data)
                   if epoch_transform is not None else train_data)
        state.model.train()
        losses = []
        for step, batch in enumerate(iterate_batches(ep_data, batch_size,
                                                     ep_rng)):
            if mesh is not None:
                batch = mesh.shard_rows(pad_batch(batch, batch_size)[0])
            with torch.random.fork_rng(devices=fork_devices), \
                    pmesh.data_parallel(mesh):
                torch.manual_seed(step_seed(seed, epoch, step, rank))
                losses.append(train_step(state, to_device(batch, device))
                              .detach())
        loss_mean = (torch.stack(losses).float().mean() if losses
                     else torch.zeros((), device=device))
        if mesh is not None:
            mesh.all_reduce_([loss_mean], mean=True)
        train_loss = float(loss_mean)

        state.model.eval()
        val_loss_sum, val_hits, val_count = 0.0, 0, 0
        with torch.no_grad():
            for batch in iterate_batches(val_data, batch_size, ep_rng,
                                         shuffle=False):
                padded, n = pad_batch(batch, batch_size)
                if mesh is not None:
                    # this rank's rows of the padded batch, of which the
                    # first n are real
                    per = batch_size // mesh.size
                    padded = mesh.shard_rows(padded)
                    n = min(max(n - rank * per, 0), per)
                logits = eval_step(state, to_device(padded, device))
                logits = logits.float().cpu()[:n]
                labels = np.asarray(padded['label'][:n])
                if labels.ndim > 1:
                    labels = labels.argmax(axis=-1)
                logp = torch.log_softmax(logits, dim=-1)
                lab = torch.from_numpy(labels.astype(np.int64))
                val_loss_sum += float(-logp.gather(1, lab[:, None]).sum())
                val_hits += int((logits.argmax(dim=-1) == lab).sum())
                val_count += n
        if mesh is not None:
            sums = torch.tensor([val_loss_sum, val_hits, val_count],
                                dtype=torch.float64, device=device)
            mesh.all_reduce_([sums])
            val_loss_sum, val_hits, val_count = sums.tolist()
        val_loss = val_loss_sum / max(val_count, 1)
        val_acc = val_hits / max(val_count, 1)

        lr_now = get_lr(state)
        history['loss'].append(train_loss)
        history['val_loss'].append(val_loss)
        history['val_acc'].append(val_acc)
        history['lr'].append(lr_now)
        log_fn(f'Epoch {epoch + 1}/{epochs} - {time.time() - t0:.1f}s - '
               f'loss: {train_loss:.4f} - val_loss: {val_loss:.4f} - '
               f'val_acc: {val_acc:.4f} - lr: {lr_now:.2e}')

        metric = val_acc if monitor == 'val_acc' else -val_loss
        stopped = False
        if metric > best_metric + min_delta:
            best_metric = metric
            best_vars = state.variables
            best_epoch = epoch
            plateau_wait = 0
            stop_wait = 0
        else:
            plateau_wait += 1
            stop_wait += 1
            if (reduce_lr_factor is not None
                    and plateau_wait >= reduce_lr_patience):
                new_lr = max(lr_now * reduce_lr_factor, min_lr)
                if new_lr < lr_now:
                    log_fn(f'ReduceLROnPlateau: lr {lr_now:.2e} '
                           f'-> {new_lr:.2e}')
                    state = set_lr(state, new_lr)
                plateau_wait = 0
            stopped = (patience is not None and stop_wait >= patience)

        # checkpoint BEFORE honouring early stop, so the stopping epoch's
        # state (callback counters included) is resumable
        if checkpoint_path and rank == 0:
            ckpt.save_train_state(
                _rank_path(checkpoint_path, mesh), state,
                extra={'epoch': epoch, 'history': history,
                       'best_metric': float(best_metric),
                       'best_vars': {k: v.numpy()
                                     for k, v in best_vars.items()},
                       'best_epoch': best_epoch,
                       'plateau_wait': plateau_wait,
                       'stop_wait': stop_wait})
        barrier(mesh)

        if on_epoch_end is not None:
            on_epoch_end(epoch, state, history)

        if stopped:
            log_fn(f'Early stopping at epoch {epoch + 1} '
                   f'(best epoch {best_epoch + 1})')
            break

    state.model.eval()
    return state, best_vars, history
