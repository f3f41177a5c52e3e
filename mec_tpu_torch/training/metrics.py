"""Evaluation metrics (numpy): a copy of mec_tpu/training/metrics.py
(importing mec_tpu imports jax), pinned to it by
tests/test_torch_train_data.py. It replaces sklearn.metrics in the
reference trainers, e.g. reference
model_training/train_speech_model.py:267-277.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if len(y_true) else 0.0


def confusion_matrix(y_true: np.ndarray, y_pred: np.ndarray,
                     num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
        cm[int(t), int(p)] += 1
    return cm


def precision_recall_f1(y_true: np.ndarray, y_pred: np.ndarray,
                        num_classes: int) -> Dict[str, np.ndarray]:
    cm = confusion_matrix(y_true, y_pred, num_classes)
    tp = np.diag(cm).astype(np.float64)
    pred_pos = cm.sum(axis=0).astype(np.float64)
    actual_pos = cm.sum(axis=1).astype(np.float64)
    with np.errstate(divide='ignore', invalid='ignore'):
        precision = np.where(pred_pos > 0, tp / pred_pos, 0.0)
        recall = np.where(actual_pos > 0, tp / actual_pos, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)
    return {'precision': precision, 'recall': recall, 'f1': f1,
            'support': actual_pos.astype(np.int64)}


def classification_report(y_true: np.ndarray, y_pred: np.ndarray,
                          target_names: Sequence[str]) -> str:
    """sklearn-style text report (per-class P/R/F1 + macro/weighted avg)."""
    n = len(target_names)
    m = precision_recall_f1(y_true, y_pred, n)
    width = max(12, max(len(t) for t in target_names) + 2)
    lines: List[str] = []
    header = (f"{'':>{width}} {'precision':>9} {'recall':>9} "
              f"{'f1-score':>9} {'support':>9}")
    lines.append(header)
    lines.append('')
    for i, name in enumerate(target_names):
        lines.append(f"{name:>{width}} {m['precision'][i]:9.2f} "
                     f"{m['recall'][i]:9.2f} {m['f1'][i]:9.2f} "
                     f"{m['support'][i]:9d}")
    lines.append('')
    total = int(m['support'].sum())
    acc = accuracy(y_true, y_pred)
    lines.append(f"{'accuracy':>{width}} {'':9} {'':9} {acc:9.2f} {total:9d}")
    macro = (m['precision'].mean(), m['recall'].mean(), m['f1'].mean())
    lines.append(f"{'macro avg':>{width}} {macro[0]:9.2f} {macro[1]:9.2f} "
                 f"{macro[2]:9.2f} {total:9d}")
    w = m['support'] / max(total, 1)
    wavg = ((m['precision'] * w).sum(), (m['recall'] * w).sum(),
            (m['f1'] * w).sum())
    lines.append(f"{'weighted avg':>{width}} {wavg[0]:9.2f} {wavg[1]:9.2f} "
                 f"{wavg[2]:9.2f} {total:9d}")
    return '\n'.join(lines)


def train_test_split_stratified(n: int, labels: np.ndarray,
                                test_size: float = 0.15, seed: int = 42):
    """Stratified index split (replaces sklearn train_test_split with
    stratify=labels, reference train_speech_model.py:187-190)."""
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels)
    if n != len(labels):
        raise ValueError(f'n={n} does not match len(labels)={len(labels)}')
    train_idx: List[int] = []
    test_idx: List[int] = []
    for cls in np.unique(labels):
        idx = np.where(labels == cls)[0]
        rng.shuffle(idx)
        k = int(round(len(idx) * test_size))
        k = min(max(k, 1 if len(idx) > 1 else 0), len(idx) - 1) \
            if len(idx) > 1 else 0
        test_idx.extend(idx[:k])
        train_idx.extend(idx[k:])
    train_idx = np.array(sorted(train_idx))
    test_idx = np.array(sorted(test_idx))
    return train_idx, test_idx
