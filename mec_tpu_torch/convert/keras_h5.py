"""Keras .h5 -> Flax-layout trees (speech DNN, Bi-LSTM text model).

A copy of mec_tpu/convert/keras_h5.py (importing mec_tpu imports jax):
the same functions, names and trees. Reads the HDF5 weight groups with
h5py (no TensorFlow). Keras Dense kernels are already (in, out) like
Flax, so no transpose; BatchNorm gamma/beta/moving stats map onto Flax
BatchNorm scale/bias/batch_stats; Keras LSTM kernels are (in, 4*units)
with gate order i, f, c~, o, which models/bilstm.py consumes. h5py and
joblib are imported when a conversion runs (convert/_imports.py: a
missing one raises an ImportError naming it).

Artifact layouts follow what the reference trainers emit:
  * models/speech_model.h5 (reference model_training/train_speech_model.py:256)
  * models/text_model.h5 + text_model_tokenizer.pkl
    (reference model_training/train_lstm_text_model.py:187-225)
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from mec_tpu_torch.convert._imports import require


def _layer_weights(h5file) -> List[Tuple[str, Dict[str, np.ndarray]]]:
    """[(layer_name, {weight_name: array})] in model order."""
    h5py = require('h5py', 'reading a Keras .h5')

    if 'model_weights' in h5file:
        g = h5file['model_weights']
    else:
        g = h5file
    layer_names = [n.decode() if isinstance(n, bytes) else n
                   for n in g.attrs['layer_names']]
    out = []
    for lname in layer_names:
        lg = g[lname]
        weights: Dict[str, np.ndarray] = {}
        names = []
        lg.visit(lambda n: names.append(n))
        for n in names:
            obj = lg[n]
            if isinstance(obj, h5py.Dataset):
                weights[n] = np.asarray(obj)
        out.append((lname, weights))
    return out


def _get(weights: Dict[str, np.ndarray], suffix: str) -> np.ndarray:
    for k, v in weights.items():
        if k.endswith(suffix) or k.endswith(suffix + ':0'):
            return v
    raise KeyError(f'{suffix} not in {list(weights)}')


def convert_speech_h5(h5_path: str) -> Dict[str, Any]:
    """speech_model.h5 -> {'params': ..., 'batch_stats': ...} for SpeechDNN."""
    h5py = require('h5py', f'converting {h5_path}')

    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    with h5py.File(h5_path, 'r') as f:
        dense_i = bn_i = 0
        layers = _layer_weights(f)
        denses = [(n, w) for n, w in layers if any('kernel' in k for k in w)
                  and not any('gamma' in k for k in w)]
        bns = [(n, w) for n, w in layers if any('gamma' in k for k in w)]
        for idx, (name, w) in enumerate(denses):
            target = f'dense_{dense_i}' if idx < len(denses) - 1 else 'dense_out'
            params[target] = {'kernel': _get(w, 'kernel'),
                              'bias': _get(w, 'bias')}
            dense_i += 1
        for name, w in bns:
            params[f'bn_{bn_i}'] = {'scale': _get(w, 'gamma'),
                                    'bias': _get(w, 'beta')}
            batch_stats[f'bn_{bn_i}'] = {'mean': _get(w, 'moving_mean'),
                                         'var': _get(w, 'moving_variance')}
            bn_i += 1
    return {'params': params, 'batch_stats': batch_stats}


def convert_lstm_text_h5(h5_path: str) -> Dict[str, Any]:
    """text_model.h5 -> {'params': ...} for BiLSTMTextModel."""
    h5py = require('h5py', f'converting {h5_path}')

    params: Dict[str, Any] = {}
    with h5py.File(h5_path, 'r') as f:
        layers = _layer_weights(f)
        bidir_idx = 0
        dense_idx = 0
        dense_names = ['dense_1', 'dense_2', 'output']
        for name, w in layers:
            if not w:
                continue  # dropout/spatial-dropout layers carry no weights
            if any('embeddings' in k for k in w):
                params['embedding'] = {'embedding': _get(w, 'embeddings')}
            elif any('recurrent_kernel' in k for k in w):
                bidir_idx += 1
                fwd = {k: v for k, v in w.items() if 'backward' not in k}
                bwd = {k: v for k, v in w.items() if 'backward' in k}
                def leaf(ws):
                    kern = next(v for k, v in ws.items()
                                if k.rstrip(':0').endswith('kernel')
                                and 'recurrent' not in k)
                    rec = next(v for k, v in ws.items()
                               if 'recurrent_kernel' in k)
                    bias = next(v for k, v in ws.items() if 'bias' in k)
                    return {'kernel': kern, 'recurrent_kernel': rec,
                            'bias': bias}
                params[f'bilstm_{bidir_idx}'] = {
                    'forward': leaf(fwd), 'backward': leaf(bwd)}
            elif any('kernel' in k for k in w):
                params[dense_names[dense_idx]] = {
                    'kernel': _get(w, 'kernel'), 'bias': _get(w, 'bias')}
                dense_idx += 1
    return {'params': params}


def load_sklearn_scaler(pkl_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """speech_scaler.pkl -> (mean, scale) float32 vectors.

    The reference standardizes features with a sklearn StandardScaler
    (reference model_training/train_speech_model.py:196-198,
    reference inference/speech_inference.py:67); unpickling it needs
    joblib and sklearn.
    """
    joblib = require('joblib', f'reading {pkl_path}')
    scaler = joblib.load(pkl_path)
    return (np.asarray(scaler.mean_, dtype=np.float32),
            np.asarray(scaler.scale_, dtype=np.float32))
