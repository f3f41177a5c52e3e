"""Bi-LSTM text trainer: the port of mec_tpu/training/train_text_lstm.py.

Parity with reference model_training/train_lstm_text_model.py: tolerant
CSV/TXT loading with joy/love -> happy folding, a Keras-style tokenizer
(vocab 10k, '<OOV>'), the Embedding(128) -> SpatialDropout -> BiLSTM(128
seq) -> BiLSTM(64) -> Dense 128 -> Dense 64 -> softmax architecture, Adam
1e-3 (clipnorm 1.0) on the cross-entropy of the clipped probabilities,
the 64/16/20 train/val/test split, EarlyStopping(patience 5),
ReduceLROnPlateau(0.5, patience 3) and the best weights. Writes
text_model.mecp (meta val_acc) and text_model_tokenizer.json beside it,
the JAX trainer's files, which both engines serve.
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
from mec_tpu_torch.models.bilstm import BiLSTMTextModel
from mec_tpu_torch.text.keras_tokenizer import KerasTokenizer
from mec_tpu_torch.training import common, data, metrics


def make_steps(model: BiLSTMTextModel):
    def train_step(state: common.TrainState, batch):
        probs, _pen = model(batch['ids'])
        logp = torch.log(torch.clamp(probs, 1e-12, 1.0))
        onehot = F.one_hot(batch['label'].long(), probs.shape[-1])
        loss = -(onehot * logp).sum(dim=-1).mean()
        loss.backward()
        state.apply_gradients()
        return loss

    def eval_step(state: common.TrainState, batch):
        probs, _pen = model(batch['ids'])
        return torch.log(torch.clamp(probs, 1e-12, 1.0))

    return train_step, eval_step


def train(csv_path: str, epochs: int = 10, batch_size: int = 32,
          vocab_size: int = 10000, max_length: Optional[int] = None,
          models_dir: Optional[str] = None, mesh_data: int = 0,
          seed: int = 42, texts=None, labels=None, verbose: bool = True,
          device='cuda'):
    """Returns (best variables as a Flax tree, tokenizer, history)."""
    mesh = common.data_mesh(mesh_data)
    dev = common.resolve_device(device)
    log = common.logger(verbose, mesh)
    max_length = max_length or Config.MAX_TEXT_LENGTH
    if texts is None:
        texts, labels = data.load_text_dataset(csv_path, fold_labels=True,
                                               verbose=verbose)
    if len(texts) == 0:
        raise SystemExit('No training data found')
    labels = np.asarray(labels)

    tokenizer = KerasTokenizer(num_words=vocab_size, oov_token='<OOV>')
    tokenizer.fit_on_texts(list(texts))
    ids = tokenizer.encode_batch(list(texts), maxlen=max_length)

    # 64/16/20: first split off 20% test, then 20%-of-remainder val
    tr_all, te = metrics.train_test_split_stratified(len(ids), labels,
                                                     0.20, seed=42)
    tr, va_rel = metrics.train_test_split_stratified(
        len(tr_all), labels[tr_all], 0.20, seed=42)
    tr_idx, va_idx = tr_all[tr], tr_all[va_rel]
    log(f'Split: train {len(tr_idx)} / val {len(va_idx)} / test {len(te)}')

    model = common.flax_init(BiLSTMTextModel(vocab_size=vocab_size),
                             seed).to(dev)
    state = common.TrainState(model, common.adam_with_clip(1e-3,
                                                           clipnorm=1.0))
    train_step, eval_step = make_steps(model)

    state, best_vars, history = common.fit(
        state,
        {'ids': ids[tr_idx], 'label': labels[tr_idx]},
        {'ids': ids[va_idx], 'label': labels[va_idx]},
        train_step, eval_step,
        epochs=epochs, batch_size=batch_size, seed=seed,
        monitor='val_acc', patience=5,
        reduce_lr_factor=0.5, reduce_lr_patience=3, log_fn=log, mesh=mesh)

    # test-set report on the best weights
    model.load_state_dict(best_vars)
    test_batch, n = common.pad_batch(
        {'ids': ids[te], 'label': labels[te]}, max(len(te), 1))
    with torch.no_grad():
        logits = eval_step(state, common.to_device(test_batch, dev))
    preds = logits.cpu().numpy()[:n].argmax(axis=-1)
    log('\nTest set report:')
    log(metrics.classification_report(labels[te], preds, Config.EMOTIONS))

    variables = to_jax(model)
    if not common.writes(mesh):
        common.barrier(mesh)
        return variables, tokenizer, history
    common.record_metrics('lstm_text', max(history['val_acc']),
                          labels[te], preds)
    models_dir = models_dir or os.path.dirname(Config.TEXT_MODEL_PATH)
    os.makedirs(models_dir, exist_ok=True)
    out = os.path.join(models_dir, 'text_model.mecp')
    store.save_params(out, variables,
                      meta={'val_acc': float(max(history['val_acc']))})
    tokenizer.to_json_file(os.path.join(models_dir,
                                        'text_model_tokenizer.json'))
    log(f'Saved {out} (+ tokenizer json)')
    common.barrier(mesh)
    return variables, tokenizer, history


def main(argv=None):
    p = argparse.ArgumentParser(description='Train the Bi-LSTM text model')
    p.add_argument('--csv', required=True)
    p.add_argument('--epochs', type=int, default=10)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--vocab-size', type=int, default=10000)
    p.add_argument('--max-length', type=int, default=Config.MAX_TEXT_LENGTH)
    p.add_argument('--models-dir', default=None)
    p.add_argument('--mesh-data', type=int, default=0,
                   help='data-parallel mesh size (0/1 = single device; N: '
                        'N ranks, one a GPU)')
    common.add_device_flag(p)
    args = p.parse_args(argv)
    train(args.csv, args.epochs, args.batch_size, args.vocab_size,
          args.max_length, args.models_dir, args.mesh_data,
          device=args.device)


if __name__ == '__main__':
    main()
