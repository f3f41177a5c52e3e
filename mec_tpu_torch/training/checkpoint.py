"""Mid-training checkpoint and resume: the port of
mec_tpu/training/checkpoint.py's msgpack-file path.

A checkpoint is the whole TrainState (the update step, the parameters
and BatchNorm statistics, the optimizer state) plus fit's extras
(epoch, history, best metric, best variables, the early-stop and
plateau counters), written by convert/store.py's msgpack to a temporary
file and moved into place with os.replace. The parameters and
statistics are in the Flax layout (convert/to_jax.py); the optimizer
state and the best variables are in the port's own layout (state-dict
names, the optimizer's per-group lists). RNG state needs no saving: fit
derives shuffle and dropout randomness per (seed, epoch, step).

The file starts with the port's magic, not the JAX package's
b'MECT\\x01', so neither package takes the other's checkpoint silently:
a JAX checkpoint (a file with its magic, or an orbax directory) raises
here with a message saying so, and the JAX reader rejects this one.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.from_jax import state_dict_from_jax
from mec_tpu_torch.convert.to_jax import to_jax

MAGIC = b'MECT-torch\x01'
JAX_MAGIC = b'MECT\x01'


def _opt_to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _opt_to_np(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_opt_to_np(v) for v in x]
    return x


def _opt_from_np(saved, like, device):
    """saved (numpy) onto the structure of `like` (the live state)."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.asarray(saved)).to(device, like.dtype)
    if isinstance(like, dict):
        return {k: _opt_from_np(saved[k], v, device) for k, v in like.items()}
    if isinstance(like, list):
        return [_opt_from_np(s, v, device) for s, v in zip(saved, like)]
    return type(like)(saved)


def save_train_state(path: str, state, extra: Optional[Dict[str, Any]] = None
                     ) -> None:
    """Write {step, params, batch_stats, opt_state, extra} to `path`."""
    variables = to_jax(state.model)
    payload = {'step': np.asarray(state.step, np.int64),
               'params': variables['params'],
               'batch_stats': variables.get('batch_stats', {}),
               'opt_state': _opt_to_np(state.opt_state),
               'extra': extra or {}}
    parts = store.serialize_parts(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(MAGIC)
        for part in parts:
            f.write(part)
    os.replace(tmp, path)


def restore_train_state(path: str, state) -> Tuple[Any, Dict[str, Any]]:
    """Restore a checkpoint of save_train_state into `state` (built with
    the same model and optimizer); returns (state, extra)."""
    if os.path.isdir(path):
        raise ValueError(f'{path} is a directory: an orbax checkpoint of the '
                         'JAX package, which mec_tpu_torch cannot resume')
    with open(path, 'rb') as f:
        blob = f.read()
    if blob.startswith(JAX_MAGIC):
        raise ValueError(f'{path} is a JAX (mec_tpu) train checkpoint; '
                         'mec_tpu_torch resumes only its own')
    if not blob.startswith(MAGIC):
        raise ValueError(f'{path} is not a mec_tpu_torch train checkpoint')
    payload = store.msgpack_restore(memoryview(blob)[len(MAGIC):])
    variables = {'params': payload['params']}
    if payload['batch_stats']:
        variables['batch_stats'] = payload['batch_stats']
    state.model.load_state_dict(state_dict_from_jax(state.model, variables))
    state.opt_state = _opt_from_np(payload['opt_state'], state.opt_state,
                                   state.device)
    state.step = int(payload['step'])
    return state, payload.get('extra') or {}
