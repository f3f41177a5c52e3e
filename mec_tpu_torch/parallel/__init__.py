"""The data axis of the device mesh, over torch.distributed: the port of
the data half of mec_tpu/parallel/.

JAX runs one process over N devices and shards the batch on a 'data'
mesh axis; here one process drives one device, and N processes form a
torch.distributed group (NCCL between CUDA ranks, gloo between CPU
ranks or between ranks sharing a card):

  * distributed.initialize_multi_host: the process group from arguments,
    the MEC_* variables or torchrun's (JAX: jax.distributed.initialize);
  * mesh: DATA_AXIS, local_mesh_shape (JAX's resolution logic),
    make_mesh(data=N) over the group, a rank's rows of a global batch,
    the broadcast of a module from rank 0 (JAX: replicated placement),
    the summed all-reduce, and data_parallel(mesh), the context a fit's
    training steps run in (BatchNorm statistics, the MoE aux loss and
    the gradients are then the global batch's);
  * launch: spawn N ranks with torch.multiprocessing, one device each.

Not ported yet (ROADMAP.md queue A item 12): the 'model' and 'pipe'
axes (tensor, pipeline, sequence and expert parallelism) and serving
data parallelism across GPUs.
"""

from mec_tpu_torch.parallel.distributed import initialize_multi_host
from mec_tpu_torch.parallel.mesh import (DATA_AXIS, DataMesh, active,
                                         data_parallel, local_mesh_shape,
                                         make_mesh)

__all__ = ['initialize_multi_host', 'DATA_AXIS', 'DataMesh', 'active',
           'data_parallel', 'local_mesh_shape', 'make_mesh']
