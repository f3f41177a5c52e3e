"""Multi-process bring-up: the port of mec_tpu/parallel/distributed.py.

JAX's initialize_multi_host calls jax.distributed.initialize once per
process; here it is torch.distributed.init_process_group, one process a
device. The same MEC_* variables configure it, and torchrun's too:

    MEC_COORDINATOR_ADDRESS  host:port of process 0   (or MASTER_ADDR
                                                        and MASTER_PORT)
    MEC_NUM_PROCESSES        total process count      (or WORLD_SIZE)
    MEC_PROCESS_ID           this process's rank      (or RANK)

Arguments win over MEC_* variables, which win over torchrun's. With
nothing configured it returns False (one process: the callers' code
path is the same either way), as JAX's does. The backend is NCCL when
this rank's device is a CUDA device and gloo otherwise; gloo can be
asked for explicitly, for several ranks on one card (NCCL refuses two
ranks on one GPU).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multi_host(coordinator_address: Optional[str] = None,
                          num_processes: Optional[int] = None,
                          process_id: Optional[int] = None,
                          device=None, backend: Optional[str] = None
                          ) -> bool:
    """init_process_group from arguments or the environment. device:
    this rank's device (default: cuda:LOCAL_RANK, else cuda:rank modulo
    the visible cards, when CUDA is available, else the CPU); a CUDA
    device becomes the current one. Returns True when a group was
    initialized (or already is), False when nothing is configured."""
    if dist.is_available() and dist.is_initialized():
        return True
    env = os.environ
    address = coordinator_address or env.get('MEC_COORDINATOR_ADDRESS')
    if not address and env.get('MASTER_ADDR') and env.get('MASTER_PORT'):
        address = f'{env["MASTER_ADDR"]}:{env["MASTER_PORT"]}'
    if not address:
        return False

    def pick(arg, *names):
        if arg is not None:
            return int(arg)
        for n in names:
            if env.get(n):
                return int(env[n])
        return None

    world = pick(num_processes, 'MEC_NUM_PROCESSES', 'WORLD_SIZE')
    rank = pick(process_id, 'MEC_PROCESS_ID', 'RANK')
    if world is None or rank is None:
        raise ValueError(f'a coordinator ({address}) needs the process count '
                         f'and this process id (got {world}, {rank})')
    if device is None:
        if torch.cuda.is_available():
            local = os.environ.get('LOCAL_RANK')
            n = torch.cuda.device_count()
            device = f'cuda:{int(local) if local else rank % n}'
        else:
            device = 'cpu'
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    dist.init_process_group(backend, init_method=f'tcp://{address}',
                            world_size=world, rank=rank)
    return True
