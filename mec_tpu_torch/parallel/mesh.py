"""The device mesh over torch.distributed: the port of
mec_tpu/parallel/mesh.py.

JAX builds a ('data', 'model'[, 'pipe']) Mesh over the visible devices
and places a batch with its leading dimension split on 'data'. Here each
rank of a torch.distributed group is one device of the mesh, and rank r
sits where JAX's make_mesh puts device r: the devices reshaped to
(data, model, pipe), so r = (d * model + m) * pipe + p.

  * local_mesh_shape: JAX's resolution of (data, model) from
    Config.MESH_DATA / MESH_MODEL and a device count (a copy, pinned by
    tests/test_torch_parallel.py);
  * make_mesh(data, model=1, pipe=1): the DataMesh of the initialized
    group, which must hold exactly data * model * pipe ranks (JAX's
    make_mesh fails its reshape with too few devices; this never shrinks
    to fewer ranks either). Each axis of more than one rank gets its own
    process groups (dist.new_group, created by every rank in one order);
    with model = pipe = 1 the data axis is the default group, as before
    those axes existed;
  * DataMesh.shard_rows: this rank's rows of a global batch (JAX's
    batch_sharding); broadcast_module: parameters and buffers from data
    rank 0 (JAX's replicated); all_reduce_sum: the autograd-aware summed
    all-reduce over the data axis; all_reduce_: sums or means in place
    over an axis (the gradients), one flat buffer a dtype;
  * data_parallel(mesh): the context a fit's training steps run in.
    models/batchnorm.train_batch_norm, models/moe.MoEFFN and
    training/common.TrainState.apply_gradients read active() and reduce
    over its data axis (JAX's GSPMD makes every batch reduction global).

The model and pipe axes' own work (tensor, sequence, expert and pipeline
parallelism) is in parallel/partition.py and parallel/pipeline.py.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mec_tpu_torch.config import Config

DATA_AXIS = 'data'
MODEL_AXIS = 'model'
PIPE_AXIS = 'pipe'


def _device_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(1, torch.cuda.device_count())


def local_mesh_shape(n_devices: Optional[int] = None) -> Tuple[int, int]:
    """Resolve (data, model) axis sizes from config + device count (the
    group's size when one is initialized, else the visible cards)."""
    total = n_devices if n_devices is not None else _device_count()
    model = max(1, int(Config.MESH_MODEL))
    if model > total or total % model != 0:
        model = 1
    data_cfg = Config.MESH_DATA
    if data_cfg == 'auto':
        data = total // model
    else:
        data = max(1, int(data_cfg))
        if data * model > total:
            data = total // model
    return data, model


@dataclass
class DataMesh:
    """This process's place in the mesh: its data rank of `size`, its
    model rank of `model` and its pipe rank of `pipe`, and the process
    groups of the axes it belongs to (None: the default group for the
    data axis when it is the only one, no group for an axis of 1)."""
    rank: int
    size: int
    model: int = 1
    pipe: int = 1
    model_rank: int = 0
    pipe_rank: int = 0
    group: Any = None
    model_group: Any = None
    pipe_group: Any = None

    @property
    def global_rank(self) -> int:
        return self.global_of(self.rank, self.model_rank, self.pipe_rank)

    def global_of(self, d: int, m: int, p: int) -> int:
        """The global rank at (data d, model m, pipe p)."""
        return (d * self.model + m) * self.pipe + p

    @property
    def alone(self) -> bool:
        """No other rank shares this rank's data axis (its size is 1 and
        the mesh has other axes): data reductions are the identity."""
        return self.size == 1 and (self.model > 1 or self.pipe > 1)

    def _group(self, axis: str):
        return {DATA_AXIS: self.group, MODEL_AXIS: self.model_group,
                PIPE_AXIS: self.pipe_group}[axis]

    def axis_size(self, axis: str) -> int:
        return {DATA_AXIS: self.size, MODEL_AXIS: self.model,
                PIPE_AXIS: self.pipe}[axis]

    def shard_rows(self, batch: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        """This rank's contiguous rows of a global batch whose leading
        dimension divides by the axis size."""
        n = len(next(iter(batch.values())))
        if n % self.size:
            raise ValueError(f'a batch of {n} rows does not split over '
                             f'{self.size} data ranks')
        per = n // self.size
        lo = self.rank * per
        return {k: v[lo:lo + per] for k, v in batch.items()}

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the data ranks, differentiable: the backward
        pass sums the ranks' gradients of the result into each input."""
        import torch.distributed.nn.functional as dfn
        if self.alone:
            return t
        return dfn.all_reduce(t, group=self.group)

    @torch.no_grad()
    def all_reduce_(self, tensors: List[torch.Tensor],
                    mean: bool = False, axis: str = DATA_AXIS) -> None:
        """Replace each tensor by its sum (mean) over the ranks of `axis`,
        in place: one all-reduce of a flat buffer a dtype."""
        if self.axis_size(axis) == 1 and (axis != DATA_AXIS or self.alone):
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=self._group(axis))
            if mean:
                flat /= self.axis_size(axis)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    @torch.no_grad()
    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Every parameter and buffer from data rank 0 (of this rank's
        model and pipe place), one broadcast of a flat buffer a dtype."""
        if self.alone:
            return
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in list(module.parameters()) + list(module.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t)
        src = self.global_of(0, self.model_rank, self.pipe_rank)
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            dist.broadcast(flat, src=src, group=self.group)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def barrier(self) -> None:
        dist.barrier()


def _describe(data: int, model: int, pipe: int) -> str:
    if model == 1 and pipe == 1:
        return f'mesh_data={data}'
    return f'mesh_data={data} x mesh_model={model} x mesh_pipe={pipe}'


def mesh_place(rank: int, model: int, pipe: int) -> Tuple[int, int, int]:
    """(data, model, pipe) place of a global rank: JAX's reshape of the
    device list to (data, model, pipe)."""
    return rank // (model * pipe), (rank // pipe) % model, rank % pipe


def make_mesh(data: int, model: int = 1, pipe: int = 1) -> DataMesh:
    """The (data, model, pipe) mesh over the initialized process group,
    which must hold exactly data * model * pipe ranks; rank r is JAX's
    device r of devs.reshape(data, model, pipe)."""
    data, model, pipe = (max(1, int(a)) for a in (data, model, pipe))
    n = data * model * pipe
    what = _describe(data, model, pipe)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f'{what} needs a torch.distributed group of {n} '
            f'ranks, and none is initialized: start the ranks with python '
            f'-m mec_tpu_torch <command> --mesh-data {data}'
            + (f' --mesh-model {model}' if model > 1 else '')
            + (f' --mesh-pipe {pipe}' if pipe > 1 else '')
            + ' (one process a GPU), torchrun, or parallel.launch, or call '
            'parallel.initialize_multi_host first')
    size = dist.get_world_size()
    if size != n:
        raise RuntimeError(f'{what} but the process group has '
                           f'{size} ranks')
    r = dist.get_rank()
    d, m, p = mesh_place(r, model, pipe)
    mesh = DataMesh(rank=d, size=data, model=model, pipe=pipe,
                    model_rank=m, pipe_rank=p)
    if model == 1 and pipe == 1:
        return mesh
    # every rank creates every group, in one order: the data axis's
    # groups (one for each model, pipe place), then the model axis's,
    # then the pipe axis's
    grid = np.arange(n).reshape(data, model, pipe)
    for axis, lines in ((DATA_AXIS, grid.transpose(1, 2, 0)),
                        (MODEL_AXIS, grid.transpose(0, 2, 1)),
                        (PIPE_AXIS, grid)):
        if mesh.axis_size(axis) == 1:
            continue
        for ranks in lines.reshape(-1, lines.shape[-1]):
            g = dist.new_group([int(x) for x in ranks])
            if r in ranks:
                setattr(mesh, {DATA_AXIS: 'group', MODEL_AXIS: 'model_group',
                               PIPE_AXIS: 'pipe_group'}[axis], g)
    return mesh


_ACTIVE: Optional[DataMesh] = None


def active() -> Optional[DataMesh]:
    """The mesh a fit's training step runs under, or None."""
    return _ACTIVE


@contextlib.contextmanager
def data_parallel(mesh: Optional[DataMesh]) -> Iterator[None]:
    """Run the body with `mesh` active (no-op for None)."""
    global _ACTIVE
    if mesh is None:
        yield
        return
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = prev
