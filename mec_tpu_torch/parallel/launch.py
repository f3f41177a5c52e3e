"""Spawn the ranks of a data axis: one process a device.

JAX drives N devices from one process; torch drives one device from
each of N processes. launch(fn, n, args) starts n fresh processes
(torch.multiprocessing, 'spawn'), gives rank r the device devices[r]
(default cuda:0 .. cuda:n-1), joins them into one torch.distributed
group on localhost (NCCL when every rank has its own GPU, else gloo),
runs fn(*args) in each and returns the ranks' results in rank order. A
failure in any rank raises here with its traceback.

It never shrinks the mesh: with fewer visible GPUs than ranks it raises
(JAX's make_mesh(data=N) fails on the reshape too). Several ranks may
share one device only over gloo; NCCL refuses two ranks on one GPU.

`python -m mec_tpu_torch <train command> --mesh-data N` starts its N
ranks here (run_module_main) unless the process is already inside a
group (torchrun's or the MEC_* variables: parallel/distributed.py).
"""

from __future__ import annotations

import importlib
import socket
import time
from typing import Any, Callable, List, Optional, Sequence

import torch


def devices_for(n: int, device='cuda', what: Optional[str] = None
                ) -> List[str]:
    """n ranks' devices: cuda:0 .. cuda:n-1 for a CUDA device type (all
    must be visible), else n times the CPU. what: the flags that asked
    for n ranks, for the error (default --mesh-data n)."""
    kind = torch.device(device).type
    if kind == 'cpu':
        return ['cpu'] * n
    if kind != 'cuda':
        raise ValueError(f'unsupported device {device}')
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n:
        raise RuntimeError(
            f'{what or f"--mesh-data {n}"} needs {n} GPUs, one a rank, and '
            f'{visible} {"is" if visible == 1 else "are"} visible: the mesh '
            f'is never shrunk (ranks sharing a card need the gloo backend: '
            f'parallel.launch.launch(..., devices=..., backend="gloo"))')
    return [f'cuda:{i}' for i in range(n)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, devices: Sequence[str],
               backend: str, threads: Optional[int], fn: Callable,
               args: tuple, queue) -> None:
    import torch.distributed as dist

    from mec_tpu_torch.parallel.distributed import initialize_multi_host
    if threads:
        torch.set_num_threads(threads)
    initialize_multi_host(f'localhost:{port}', world, rank,
                          device=devices[rank], backend=backend)
    try:
        queue.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, args: tuple = (),
           devices: Optional[Sequence[str]] = None,
           backend: Optional[str] = None, threads: Optional[int] = None,
           timeout: Optional[float] = None) -> List[Any]:
    """fn(*args) in n ranks of one group; their results in rank order.
    fn must be importable by name (a module-level function). threads:
    torch's intra-op threads in each rank. timeout: seconds before every
    rank is killed and TimeoutError raised."""
    import torch.multiprocessing as mp

    devices = list(devices) if devices is not None else devices_for(n)
    if len(devices) != n:
        raise ValueError(f'{n} ranks but {len(devices)} devices')
    cuda = [torch.device(d).type == 'cuda' for d in devices]
    backend = backend or ('nccl' if all(cuda) and len(set(devices)) == n
                          else 'gloo')
    if backend == 'nccl' and len(set(devices)) < n:
        raise ValueError(f'NCCL needs one GPU a rank (devices {devices}); '
                         f'ranks sharing a device need backend="gloo"')
    ctx = mp.get_context('spawn')
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(n, free_port(), devices, backend, threads, fn,
                          args, queue),
        nprocs=n, join=False, start_method='spawn')
    results = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            while not queue.empty():
                rank, out = queue.get()
                results[rank] = out
            if procs.join(timeout=0.1):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f'{n} ranks still running after '
                                   f'{timeout} s')
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    while not queue.empty():
        rank, out = queue.get()
        results[rank] = out
    return [results[r] for r in range(n)]


def run_module_main(module: str, argv: List[str]) -> None:
    """One rank of `python -m mec_tpu_torch <command> --mesh-data N`:
    the command module's main(argv) inside the group."""
    importlib.import_module(module).main(argv)
