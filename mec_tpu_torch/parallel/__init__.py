"""The device mesh over torch.distributed: the port of mec_tpu/parallel/.

JAX runs one process over N devices and shards arrays on named mesh
axes; here one process drives one device, and the processes form a
torch.distributed group (NCCL between CUDA ranks, gloo between CPU
ranks or between ranks sharing a card):

  * distributed.initialize_multi_host: the process group from arguments,
    the MEC_* variables or torchrun's (JAX: jax.distributed.initialize);
  * mesh: DATA_AXIS, MODEL_AXIS, PIPE_AXIS, local_mesh_shape (JAX's
    resolution logic), make_mesh(data, model, pipe) over the group in
    JAX's device order with a process group an axis, a rank's rows of a
    global batch, the broadcast of a module from data rank 0 (JAX:
    replicated placement), the summed all-reduce, and
    data_parallel(mesh), the context a fit's training steps run in
    (BatchNorm statistics, the MoE aux loss and the gradients are then
    the global batch's);
  * partition: JAX's BERT partition rules, Megatron tensor parallelism,
    sequence parallelism and expert parallelism over 'model'
    (shard_bert, gather_bert);
  * pipeline: a GPipe schedule of the BERT encoder over 'pipe';
  * launch: spawn N ranks with torch.multiprocessing, one device each.

Serving data parallelism across GPUs (the JAX engine's mesh) is the
engine's own: serving/engine.py, one replica of the models a card.
"""

from mec_tpu_torch.parallel.distributed import initialize_multi_host
from mec_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                         DataMesh, active, data_parallel,
                                         local_mesh_shape, make_mesh)

__all__ = ['initialize_multi_host', 'DATA_AXIS', 'MODEL_AXIS', 'PIPE_AXIS',
           'DataMesh', 'active', 'data_parallel', 'local_mesh_shape',
           'make_mesh']
