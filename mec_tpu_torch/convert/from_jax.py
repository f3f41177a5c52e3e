"""JAX-package parameters -> the port's parameters.

The port reads the numpy trees the JAX package uses (a Flax
{'params', 'batch_stats'} tree of arrays), not the .mecp files on disk:
those are Flax msgpack, and the card's machine has no flax or msgpack.

Two consumers take the same tree:
  * speech_state_from_jax -> the state dict of models.SpeechDNN (the
    plain model); Flax Dense kernels are (in, out), torch Linear.weight
    is (out, in).
  * ops.speech_kernels.make_speech_dnn -> the folded kernel weights
    (BatchNorm folded into each Dense by fold_batchnorm, flattened).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def speech_widths(variables: Dict) -> Tuple[int, ...]:
    """Hidden widths of a speech tree (dense_0 .. dense_{n-1})."""
    p = variables['params']
    n = sum(1 for k in p if k.startswith('bn_'))
    return tuple(int(np.shape(p[f'dense_{i}']['kernel'])[1])
                 for i in range(n))


def speech_state_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """Flax SpeechDNN variables -> models.SpeechDNN state dict."""
    p = variables['params']
    s = variables.get('batch_stats', {})
    state = {}
    for i in range(len(speech_widths(variables))):
        state[f'dense.{i}.weight'] = _t(np.asarray(p[f'dense_{i}']['kernel']).T)
        state[f'dense.{i}.bias'] = _t(p[f'dense_{i}']['bias'])
        state[f'bn.{i}.weight'] = _t(p[f'bn_{i}']['scale'])
        state[f'bn.{i}.bias'] = _t(p[f'bn_{i}']['bias'])
        state[f'bn.{i}.running_mean'] = _t(s[f'bn_{i}']['mean'])
        state[f'bn.{i}.running_var'] = _t(s[f'bn_{i}']['var'])
        state[f'bn.{i}.num_batches_tracked'] = torch.tensor(0)
    state['out.weight'] = _t(np.asarray(p['dense_out']['kernel']).T)
    state['out.bias'] = _t(p['dense_out']['bias'])
    return state
