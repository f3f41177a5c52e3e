"""Speech emotion DNN trainer: the port of mec_tpu/training/train_speech.py.

Parity with reference model_training/train_speech_model.py: the
SpeechDNN architecture with its dropouts and Keras BatchNorm (momentum
0.99, eps 1e-3), 85/15 stratified split, standardisation, 3x Gaussian
noise augmentation (sigma 0.05 and 0.1), Adam 1e-3 with clipnorm 1.0,
cross-entropy on the clipped probabilities plus L2 1e-4 on the Dense
kernels, EarlyStopping(val_acc, patience 25), ReduceLROnPlateau(0.5,
patience 10) and the best weights.

The dataset's features come from the device's parity frontend
(data.load_speech_dataset; K2 once a chunk of 256 clips on the card).
Writes speech_model.mecp (meta val_acc) and speech_scaler.npz, the JAX
trainer's files.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.models.batchnorm import wide
from mec_tpu_torch.models.speech_dnn import SpeechDNN
from mec_tpu_torch.training import common, data, metrics

L2 = 1e-4  # Keras kernel_regularizer=l2(1e-4)


def l2_penalty(model: SpeechDNN) -> torch.Tensor:
    kernels = [d.weight for d in model.dense] + [model.out.weight]
    return L2 * sum((wide(w) ** 2).sum() for w in kernels)


def make_steps(model: SpeechDNN):
    def train_step(state: common.TrainState, batch):
        p, _ = model(batch['x'])
        logp = torch.log(torch.clamp(p, 1e-12, 1.0))
        ce = -(batch['label'] * logp).sum(dim=-1).mean()
        loss = ce + l2_penalty(model)
        loss.backward()
        state.apply_gradients()
        return loss

    def eval_step(state: common.TrainState, batch):
        probs, _ = model(batch['x'])
        return torch.log(torch.clamp(probs, 1e-12, 1.0))

    return train_step, eval_step


def train(data_root: str = 'datasets/speech', pattern: str = '**/*.wav',
          label_from: str = 'parent', epochs: int = 200,
          batch_size: int = 64, augment: bool = True,
          models_dir: Optional[str] = None, mesh_data: int = 0,
          seed: int = 42, X: Optional[np.ndarray] = None,
          y: Optional[np.ndarray] = None, verbose: bool = True,
          checkpoint_path: Optional[str] = None, resume: bool = False,
          device='cuda'):
    """Returns (best variables as a Flax tree, (mean, scale), history)."""
    mesh = common.data_mesh(mesh_data)
    dev = common.resolve_device(device)
    log = common.logger(verbose, mesh)
    if X is None:
        X, y = data.load_speech_dataset(data_root, pattern, label_from,
                                        verbose=verbose, device=dev)
    if len(X) == 0:
        raise SystemExit('No training data found')

    tr, va = metrics.train_test_split_stratified(len(X), y, 0.15, seed=42)
    X_train, X_val = X[tr], X[va]
    y_train, y_val = y[tr], y[va]

    mean = X_train.mean(axis=0)
    scale = X_train.std(axis=0)
    scale = np.where(scale > 0, scale, 1.0)
    X_train = ((X_train - mean) / scale).astype(np.float32)
    X_val = ((X_val - mean) / scale).astype(np.float32)

    if augment:
        rng = np.random.RandomState(seed)
        X_train = np.vstack([
            X_train,
            X_train + rng.normal(0, 0.05, X_train.shape),
            X_train + rng.normal(0, 0.10, X_train.shape),
        ]).astype(np.float32)
        y_train = np.concatenate([y_train] * 3)
        log(f'Augmented training set: {len(X_train)} samples')

    onehot = np.eye(Config.NUM_EMOTIONS, dtype=np.float32)
    model = common.flax_init(SpeechDNN(in_dim=X.shape[1]), seed).to(dev)
    state = common.TrainState(model, common.adam_with_clip(1e-3,
                                                           clipnorm=1.0))
    train_step, eval_step = make_steps(model)

    state, best_vars, history = common.fit(
        state,
        {'x': X_train, 'label': onehot[y_train]},
        {'x': X_val, 'label': onehot[y_val]},
        train_step, eval_step,
        epochs=epochs, batch_size=batch_size, seed=seed,
        monitor='val_acc', patience=25,
        reduce_lr_factor=0.5, reduce_lr_patience=10, min_lr=1e-6,
        log_fn=log, checkpoint_path=checkpoint_path, resume=resume,
        mesh=mesh)

    # evaluation report on the best weights
    model.load_state_dict(best_vars)
    with torch.no_grad():
        logits = eval_step(state, common.to_device({'x': X_val}, dev))
    preds = logits.cpu().numpy().argmax(axis=-1)
    log('\n' + metrics.classification_report(y_val, preds, Config.EMOTIONS))

    variables = to_jax(model)
    if not common.writes(mesh):
        common.barrier(mesh)
        return variables, (mean, scale), history
    common.record_metrics('speech_dnn', max(history['val_acc']),
                          y_val, preds)
    models_dir = models_dir or os.path.dirname(Config.SPEECH_MODEL_PATH)
    os.makedirs(models_dir, exist_ok=True)
    out = os.path.join(models_dir, 'speech_model.mecp')
    store.save_params(out, variables,
                      meta={'val_acc': float(max(history['val_acc']))})
    np.savez(os.path.join(models_dir, 'speech_scaler.npz'),
             mean=mean.astype(np.float32), scale=scale.astype(np.float32))
    log(f'Saved {out} (+ scaler npz)')
    common.barrier(mesh)
    return variables, (mean, scale), history


def main(argv=None):
    p = argparse.ArgumentParser(description='Train the speech emotion DNN')
    p.add_argument('--data-root', default='datasets/speech')
    p.add_argument('--pattern', default='**/*.wav')
    p.add_argument('--label-from', default='parent',
                   choices=['parent', 'name'])
    p.add_argument('--epochs', type=int, default=200)
    p.add_argument('--batch-size', type=int, default=64)
    p.add_argument('--no-augment', action='store_true')
    p.add_argument('--models-dir', default=None)
    p.add_argument('--mesh-data', type=int, default=0,
                   help='data-parallel mesh size (0/1 = single device; N: '
                        'N ranks, one a GPU)')
    p.add_argument('--checkpoint', default=None,
                   help='path for per-epoch full train-state checkpoints')
    p.add_argument('--resume', action='store_true',
                   help='resume from --checkpoint')
    common.add_device_flag(p)
    args = p.parse_args(argv)
    train(args.data_root, args.pattern, args.label_from, args.epochs,
          args.batch_size, not args.no_augment, args.models_dir,
          args.mesh_data, checkpoint_path=args.checkpoint,
          resume=args.resume, device=args.device)


if __name__ == '__main__':
    main()
