"""Multimodal fusion trainer: the port of mec_tpu/training/train_fusion.py.

Parity with reference model_training/train_fusion_model.py: the
synthetic data generator (class-shifted Gaussian features, 64/768/512
wide at label * 0.3/0.2/0.25, and Dirichlet(0.5) predictions peaked at
the true label; generate_synthetic_data is a numpy copy of the JAX
package's, bit for bit), AdamW 1e-3 wd 0.01 with grad clip 1.0,
CosineAnnealingWarmRestarts(T_0 10, T_mult 2) as a schedule of the
update count, early stop patience 15, the dims config in the checkpoint
meta, and the per-epoch mean attention and decision weights on a fixed
probe batch.

--manifest trains on real multimodal triples, their features from the
port's own engine over the models directory (extract_real_features).
Writes fusion_model.mecp (meta config, val_acc), the JAX trainer's file.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.models.fusion import MultiModalFusionModel
from mec_tpu_torch.training import common, metrics

_INPUTS = ('s_feat', 't_feat', 'i_feat', 's_pred', 't_pred', 'i_pred')


def generate_synthetic_data(num_samples: int = 10000, seed: int = 42,
                            dims: Optional[dict] = None
                            ) -> Tuple[np.ndarray, ...]:
    """Class-correlated Gaussians + Dirichlet-noised peaked predictions.

    `dims` overrides the per-modality feature widths (default: speech
    penultimate 64, BERT CLS 768, image head 512); pass the served
    encoders' widths when they are not the defaults."""
    rng = np.random.RandomState(seed)
    C = Config.NUM_EMOTIONS
    dims = dict(dims or {'speech': 64, 'text': 768, 'image': 512})
    shifts = {'speech': 0.3, 'text': 0.2, 'image': 0.25}
    peaks = {'speech': (0.3, 0.6), 'text': (0.4, 0.7), 'image': (0.2, 0.5)}

    labels = np.arange(num_samples) % C
    feats = {}
    preds = {}
    for mod in dims:
        feats[mod] = (rng.randn(num_samples, dims[mod])
                      + labels[:, None] * shifts[mod]).astype(np.float32)
        p = rng.dirichlet(np.ones(C) * 0.5, size=num_samples)
        lo, hi = peaks[mod]
        p[np.arange(num_samples), labels] += rng.uniform(lo, hi,
                                                         num_samples)
        preds[mod] = (p / p.sum(axis=1, keepdims=True)).astype(np.float32)
    return (feats['speech'], feats['text'], feats['image'],
            preds['speech'], preds['text'], preds['image'],
            labels.astype(np.int32))


def extract_real_features(manifest_csv: str,
                          models_dir: Optional[str] = None,
                          chunk: int = 32, verbose: bool = True,
                          device='cuda'):
    """Manifest CSV (audio_path,text,image_path,label) -> fusion dataset:
    one engine pass per modality chunk returns the probabilities and the
    fusion features together."""
    import csv as _csv

    from mec_tpu_torch.serving.engine import EmotionEngine

    label_to_idx = {e: i for i, e in enumerate(Config.EMOTIONS)}
    rows = []
    with open(manifest_csv, newline='', encoding='utf-8') as f:
        for row in _csv.DictReader(f):
            if row.get('label', '').lower() in label_to_idx:
                rows.append(row)
    if not rows:
        raise SystemExit(f'no usable rows in {manifest_csv}')
    if verbose:
        print(f'Extracting features for {len(rows)} triples...')

    # this rank's card alone: the data ranks of a --mesh-data run each
    # own one
    engine = EmotionEngine.from_models_dir(models_dir, device=device,
                                           mesh=None)
    if not (engine.speech and engine.bert and engine.image):
        raise SystemExit('real-feature extraction requires speech, bert, '
                         'and image artifacts')

    s_f, t_f, i_f, s_p, t_p, i_p, labels = [], [], [], [], [], [], []
    for s in range(0, len(rows), chunk):
        part = rows[s:s + chunk]
        sp = engine.predict_speech_paths([r['audio_path'] for r in part],
                                         want_features=True)
        tx = engine.predict_texts([r['text'] for r in part],
                                  want_features=True)
        im = engine.predict_image_paths([r['image_path'] for r in part],
                                        want_features=True)
        for r, a, b, c in zip(part, sp, tx, im):
            s_f.append(a['_features'])
            t_f.append(b['_features'])
            i_f.append(c['_features'])
            s_p.append(a['all_probabilities'])
            t_p.append(b['all_probabilities'])
            i_p.append(c['all_probabilities'])
            labels.append(label_to_idx[r['label'].lower()])
    return (np.asarray(s_f, np.float32), np.asarray(t_f, np.float32),
            np.asarray(i_f, np.float32), np.asarray(s_p, np.float32),
            np.asarray(t_p, np.float32), np.asarray(i_p, np.float32),
            np.asarray(labels, np.int32))


def warm_restarts(learning_rate: float, epochs: int, steps_per_epoch: int
                  ) -> common.Schedule:
    """CosineAnnealingWarmRestarts(T_0=10, T_mult=2) over epoch
    boundaries, as a schedule of the update count (JAX
    train_fusion.py:180-192)."""
    schedules, boundaries = [], []
    t, total = 10, 0
    while total < epochs:
        span = min(t, epochs - total) * steps_per_epoch
        schedules.append(common.cosine_decay_schedule(learning_rate, span))
        total += t
        boundaries.append(total * steps_per_epoch)
        t *= 2
    return (common.join_schedules(schedules, boundaries[:-1])
            if len(schedules) > 1 else schedules[0])


def make_steps(model: MultiModalFusionModel):
    def train_step(state: common.TrainState, batch):
        logits, _aw, _dw = model(*(batch[k] for k in _INPUTS))
        onehot = F.one_hot(batch['label'].long(), logits.shape[-1])
        loss = common.softmax_cross_entropy(logits, onehot)
        loss.backward()
        state.apply_gradients()
        return loss

    def eval_step(state: common.TrainState, batch):
        logits, _aw, _dw = model(*(batch[k] for k in _INPUTS))
        return logits

    return train_step, eval_step


def train(num_samples: int = 10000, epochs: int = 100,
          batch_size: int = 64, learning_rate: float = 1e-3,
          models_dir: Optional[str] = None, mesh_data: int = 0,
          seed: int = 42, dataset=None, verbose: bool = True,
          device='cuda'):
    """Returns (best variables as a Flax tree, config, history)."""
    mesh = common.data_mesh(mesh_data)
    dev = common.resolve_device(device)
    log = common.logger(verbose, mesh)
    if dataset is None:
        log('Generating synthetic training data...')
        dataset = generate_synthetic_data(num_samples, seed)
    s_f, t_f, i_f, s_p, t_p, i_p, labels = dataset

    tr, va = metrics.train_test_split_stratified(len(labels), labels,
                                                 0.15, seed=42)

    def sub(idx):
        return {'s_feat': s_f[idx], 't_feat': t_f[idx], 'i_feat': i_f[idx],
                's_pred': s_p[idx], 't_pred': t_p[idx], 'i_pred': i_p[idx],
                'label': labels[idx]}

    cfg = {'speech_dim': int(s_f.shape[1]), 'text_dim': int(t_f.shape[1]),
           'image_dim': int(i_f.shape[1]), 'num_classes': Config.NUM_EMOTIONS,
           'hidden_dim': 256}
    model = common.flax_init(MultiModalFusionModel(**cfg), seed).to(dev)
    lr = warm_restarts(learning_rate, epochs,
                       max(1, len(tr) // batch_size))
    state = common.TrainState(model, common.adamw_with_clip(
        lr, weight_decay=0.01, clipnorm=1.0))
    train_step, eval_step = make_steps(model)

    # per-epoch mean attention/decision weights (reference
    # train_fusion_model.py:602-603), on a fixed probe batch
    probe = common.to_device({k: v[:64] for k, v in sub(va).items()}, dev)

    def on_epoch_end(epoch, state, history):
        with torch.no_grad():
            _logits, aw, dw = model(*(probe[k] for k in _INPUTS))
        log(f'  mean attention weights [s,t,i]: '
            f'{np.round(aw.mean(0).cpu().numpy(), 3).tolist()} | decision '
            f'weights: {np.round(dw.mean(0).cpu().numpy(), 3).tolist()}')

    state, best_vars, history = common.fit(
        state, sub(tr), sub(va), train_step, eval_step,
        epochs=epochs, batch_size=batch_size, seed=seed,
        monitor='val_acc', patience=15, log_fn=log,
        on_epoch_end=on_epoch_end, mesh=mesh)

    model.load_state_dict(best_vars)
    padded, n = common.pad_batch(sub(va), len(va))
    with torch.no_grad():
        logits = eval_step(state, common.to_device(padded, dev))
    preds = logits.cpu().numpy()[:n].argmax(axis=-1)
    log('\n' + metrics.classification_report(labels[va], preds,
                                             Config.EMOTIONS))

    variables = to_jax(model)
    if not common.writes(mesh):
        common.barrier(mesh)
        return variables, cfg, history
    common.record_metrics('fusion_attention', max(history['val_acc']),
                          labels[va], preds)
    models_dir = models_dir or os.path.dirname(Config.FUSION_MODEL_PATH)
    os.makedirs(models_dir, exist_ok=True)
    out = os.path.join(models_dir, 'fusion_model.mecp')
    store.save_params(out, variables,
                      meta={'config': cfg,
                            'val_acc': float(max(history['val_acc']))})
    log(f'Saved {out}')
    common.barrier(mesh)
    return variables, cfg, history


def main(argv=None):
    p = argparse.ArgumentParser(description='Train the fusion model')
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--batch-size', type=int, default=64)
    p.add_argument('--learning-rate', type=float, default=1e-3)
    p.add_argument('--num-samples', type=int, default=10000)
    p.add_argument('--models-dir', default=None)
    p.add_argument('--mesh-data', type=int, default=0,
                   help='data-parallel mesh size (0/1 = single device; N: '
                        'N ranks, one a GPU)')
    p.add_argument('--manifest', default=None,
                   help='CSV of audio_path,text,image_path,label rows: '
                        'train on real multimodal triples instead of '
                        'synthetic data')
    common.add_device_flag(p)
    args = p.parse_args(argv)
    dataset = (extract_real_features(args.manifest, args.models_dir,
                                     device=args.device)
               if args.manifest else None)
    train(args.num_samples, args.epochs, args.batch_size,
          args.learning_rate, args.models_dir, args.mesh_data,
          dataset=dataset, device=args.device)


if __name__ == '__main__':
    main()
