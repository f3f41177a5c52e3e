"""Facial-emotion image trainer (two-phase fine-tune): the port of
mec_tpu/training/train_image.py.

ResNet50 by default, --arch mobilenet_v2 for the README's MobileNetV2.
Parity with reference model_training/train_image_model.py: ImageFolder
layout, flip/rotate/colour-jitter augmentation drawn afresh each epoch,
85/15 split, phase 1 trains the head at 10x LR with the backbone frozen
(at most phase1_epochs), phase 2 fine-tunes every layer at the base LR
under AdamW (wd 0.01) with cosine decay over the phase's optimizer
updates, early stop patience 5, the best weights of either phase.

Phase 1 is make_tx: the global-norm clip, then a multi_transform of the
head (AdamW at head_lr) and the backbone (set to zero). The clip runs
before the split, so the frozen backbone's gradients are computed and
count in the norm, and are then not applied (requires_grad False would
change the head's update). BatchNorm statistics update in both phases.
The training forward is the models' live-BN form with F.max_pool2d in
the ResNet50 stem (K6 and K7 have no backward and never train).
--grad-accum K, --remat and --bf16 (torch.autocast) as in the BERT
trainer. Writes image_model.mecp (meta val_acc, arch, img_size), the JAX
trainer's file; img_size routes the serving image path.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.image.preprocess import IMAGENET_MEAN, IMAGENET_STD
from mec_tpu_torch.models.mobilenet import MobileNetV2EmotionModel
from mec_tpu_torch.models.resnet import ImageEmotionModel
from mec_tpu_torch.training import common, data, metrics

ARCHS = {'resnet50': ImageEmotionModel,
         'mobilenet_v2': MobileNetV2EmotionModel}


def _label_of(name: str) -> str:
    """'head' for the custom fc1/fc2 head, 'backbone' for the rest."""
    return ('head' if any(k.startswith('fc') for k in name.split('.'))
            else 'backbone')


def make_tx(lr, head_lr, freeze_backbone: bool, weight_decay: float = 0.01
            ) -> common.Tx:
    """Two groups after the clip: the head at head_lr, the backbone at lr
    (or frozen: optax.set_to_zero)."""
    backbone = (None if freeze_backbone
                else common.Adam(lr, weight_decay, inject=False))
    return common.Tx({'head': common.Adam(head_lr, weight_decay,
                                          inject=False),
                      'backbone': backbone},
                     label=_label_of, clipnorm=1.0)


def make_steps(model, bf16: bool = False):
    dev = next(model.parameters()).device
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(IMAGENET_STD).to(dev)

    def forward(batch):
        x = (batch['img'].float() / 255.0 - mean) / std
        with torch.autocast(dev.type, torch.bfloat16, enabled=bf16):
            logits, _feat = model(x)
        return logits

    def train_step(state: common.TrainState, batch):
        logits = forward(batch)
        onehot = F.one_hot(batch['label'].long(), logits.shape[-1])
        loss = common.softmax_cross_entropy(logits, onehot)
        loss.backward()
        state.apply_gradients()
        return loss

    def eval_step(state: common.TrainState, batch):
        return forward(batch)

    return train_step, eval_step


def train(data_root: str, img_size: int = 224, batch_size: int = 32,
          epochs: int = 30, learning_rate: float = 1e-4,
          phase1_epochs: int = 10, models_dir: Optional[str] = None,
          mesh_data: int = 0, seed: int = 42, augment: bool = True,
          imgs: Optional[np.ndarray] = None,
          labels: Optional[np.ndarray] = None, verbose: bool = True,
          bf16: bool = False, arch: str = 'resnet50',
          grad_accum: int = 1, remat: bool = False, device='cuda'):
    """Returns (best variables as a Flax tree, {'phase1', 'phase2'}
    histories)."""
    if arch not in ARCHS:
        raise SystemExit(f'unknown --arch {arch}')
    mesh = common.data_mesh(mesh_data)
    dev = common.resolve_device(device)
    log = common.logger(verbose, mesh)
    if img_size % 2:
        raise SystemExit(f'--img-size {img_size} must be even: serving '
                         'ships YUV 4:2:0 images (2x2 chroma subsampling)')
    if imgs is None:
        paths, labels = data.list_image_dataset(data_root, verbose=verbose)
        if not paths:
            raise SystemExit('No training data found')
        imgs = data.load_images_uint8(paths, img_size, verbose=verbose)

    tr, va = metrics.train_test_split_stratified(len(imgs), labels,
                                                 0.15, seed=42)
    train_data = {'img': imgs[tr], 'label': labels[tr]}
    val_data = {'img': imgs[va], 'label': labels[va]}

    # a fresh augmentation draw each epoch from the originals
    epoch_transform = None
    if augment:
        def epoch_transform(epoch, d):
            ep_rng = np.random.RandomState((seed * 9176 + epoch) % 2**32)
            return {'img': data.augment_images_uint8(d['img'], ep_rng),
                    'label': d['label']}
    log(f'Training set: {len(tr)}  validation set: {len(va)}')
    if remat:
        log('rematerialization: block activations recomputed in the '
            'backward pass (torch.utils.checkpoint)')

    model = common.flax_init(ARCHS[arch](remat=remat), seed).to(dev)
    train_step, eval_step = make_steps(model, bf16)

    grad_accum = max(1, int(grad_accum))
    if grad_accum > 1:
        log(f'gradient accumulation: {grad_accum} micro-batches of '
            f'{batch_size} per optimizer update (effective batch '
            f'{batch_size * grad_accum})')

    def accum(tx):
        return common.multi_steps(tx, grad_accum) if grad_accum > 1 else tx

    log('\nPhase 1: training classifier head (backbone frozen)')
    state = common.TrainState(model, accum(make_tx(
        learning_rate, learning_rate * 10, freeze_backbone=True)))
    state, best_vars, hist1 = common.fit(
        state, train_data, val_data, train_step, eval_step,
        epochs=min(phase1_epochs, epochs), batch_size=batch_size,
        seed=seed, monitor='val_acc', patience=5, log_fn=log,
        epoch_transform=epoch_transform, mesh=mesh)

    remaining = max(epochs - phase1_epochs, 0)
    hist2 = {'val_acc': [0.0]}
    if remaining:
        log('\nPhase 2: fine-tuning all layers')
        steps = common.optimizer_total_steps(len(tr), batch_size,
                                             remaining, grad_accum)
        sched = common.cosine_decay_schedule(learning_rate, steps)
        model.load_state_dict(best_vars)
        state = common.TrainState(model, accum(common.adamw_with_clip(
            sched, weight_decay=0.01)))
        state, best_vars2, hist2 = common.fit(
            state, train_data, val_data, train_step, eval_step,
            epochs=remaining, batch_size=batch_size, seed=seed + 1,
            monitor='val_acc', patience=5, log_fn=log,
            epoch_transform=epoch_transform, mesh=mesh)
        if max(hist2['val_acc']) >= max(hist1['val_acc']):
            best_vars = best_vars2

    model.load_state_dict(best_vars)
    padded, n = common.pad_batch(val_data, len(va))
    with torch.no_grad():
        logits = eval_step(state, common.to_device(padded, dev))
    preds = logits.float().cpu().numpy()[:n].argmax(axis=-1)
    log('\n' + metrics.classification_report(labels[va], preds,
                                             Config.EMOTIONS))
    best_acc = max(max(hist1['val_acc']), max(hist2['val_acc']))

    variables = to_jax(model)
    hists = {'phase1': hist1, 'phase2': hist2}
    if not common.writes(mesh):
        common.barrier(mesh)
        return variables, hists
    common.record_metrics(f'image_{arch}', best_acc, labels[va], preds)
    models_dir = models_dir or os.path.dirname(Config.IMAGE_MODEL_PATH)
    os.makedirs(models_dir, exist_ok=True)
    out = os.path.join(models_dir, 'image_model.mecp')
    store.save_params(out, variables,
                      meta={'val_acc': float(best_acc), 'arch': arch,
                            'img_size': int(img_size)})
    log(f'Saved {out}')
    common.barrier(mesh)
    return variables, hists


def main(argv=None):
    p = argparse.ArgumentParser(description='Train the facial ResNet50')
    p.add_argument('--data-root', required=True)
    p.add_argument('--img-size', type=int, default=224)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--epochs', type=int, default=30)
    p.add_argument('--learning-rate', type=float, default=1e-4)
    p.add_argument('--phase1-epochs', type=int, default=10)
    p.add_argument('--models-dir', default=None)
    p.add_argument('--mesh-data', type=int, default=0,
                   help='data-parallel mesh size (0/1 = single device; N: '
                        'N ranks, one a GPU)')
    p.add_argument('--bf16', action='store_true',
                   help='bfloat16 compute under torch.autocast (params '
                        'stay float32)')
    p.add_argument('--grad-accum', type=int, default=1,
                   help='accumulate gradients over K micro-batches '
                        'before each optimizer update (optax.MultiSteps;'
                        ' effective batch = batch-size * K)')
    p.add_argument('--remat', action='store_true',
                   help='recompute block activations in the backward '
                        'pass (torch.utils.checkpoint)')
    p.add_argument('--arch', default='resnet50',
                   choices=('resnet50', 'mobilenet_v2'),
                   help='resnet50 = the reference code; mobilenet_v2 = '
                        'the README-advertised fast variant')
    common.add_device_flag(p)
    args = p.parse_args(argv)
    train(args.data_root, args.img_size, args.batch_size, args.epochs,
          args.learning_rate, args.phase1_epochs, args.models_dir,
          args.mesh_data, bf16=args.bf16, arch=args.arch,
          grad_accum=args.grad_accum, remat=args.remat, device=args.device)


if __name__ == '__main__':
    main()
