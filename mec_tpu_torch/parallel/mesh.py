"""The data axis of the mesh: the port of mec_tpu/parallel/mesh.py's
data half.

JAX builds a ('data', 'model') Mesh over the visible devices and places
a batch with its leading dimension split on 'data'. Here each rank of a
torch.distributed group is one device of the data axis:

  * local_mesh_shape: JAX's resolution of (data, model) from
    Config.MESH_DATA / MESH_MODEL and a device count (a copy, pinned by
    tests/test_torch_parallel.py);
  * make_mesh(data=N): the DataMesh of the initialized group, which must
    hold exactly N ranks (JAX's make_mesh fails its reshape with too few
    devices; this never shrinks to fewer ranks either);
  * DataMesh.shard_rows: this rank's rows of a global batch (JAX's
    batch_sharding); broadcast_module: parameters and buffers from rank
    0 (JAX's replicated); all_reduce_sum: the autograd-aware summed
    all-reduce; all_reduce_: sums or means in place (the gradients),
    one flat buffer a dtype;
  * data_parallel(mesh): the context a fit's training steps run in.
    models/batchnorm.train_batch_norm, models/moe.MoEFFN and
    training/common.TrainState.apply_gradients read active() and reduce
    over its group (JAX's GSPMD makes every batch reduction global).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mec_tpu_torch.config import Config

DATA_AXIS = 'data'


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
    """The data axis: this process's rank in the default process group
    of `size` ranks."""
    rank: int
    size: int

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
        """The sum of t over the ranks, differentiable: the backward pass
        sums the ranks' gradients of the result into each input."""
        import torch.distributed.nn.functional as dfn
        return dfn.all_reduce(t)

    @torch.no_grad()
    def all_reduce_(self, tensors: List[torch.Tensor],
                    mean: bool = False) -> None:
        """Replace each tensor by its sum (mean) over the ranks, in place:
        one all-reduce of a flat buffer a dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat)
            if mean:
                flat /= self.size
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    @torch.no_grad()
    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Every parameter and buffer from rank 0, one broadcast of a flat
        buffer a dtype."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in list(module.parameters()) + list(module.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            dist.broadcast(flat, src=0)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()

    def barrier(self) -> None:
        dist.barrier()


def make_mesh(data: int) -> DataMesh:
    """The data axis of `data` ranks over the initialized process group
    (which must hold exactly that many ranks)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f'mesh_data={data} needs a torch.distributed group of {data} '
            f'ranks, and none is initialized: start the ranks with python '
            f'-m mec_tpu_torch <command> --mesh-data {data} (one process a '
            f'GPU), torchrun, or parallel.launch, or call '
            f'parallel.initialize_multi_host first')
    size = dist.get_world_size()
    if size != data:
        raise RuntimeError(f'mesh_data={data} but the process group has '
                           f'{size} ranks')
    return DataMesh(rank=dist.get_rank(), size=size)


_ACTIVE: Optional[DataMesh] = None


def active() -> Optional[DataMesh]:
    """The data mesh a fit's training step runs under, or None."""
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
