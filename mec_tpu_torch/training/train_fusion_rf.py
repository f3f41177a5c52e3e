"""Random-forest fusion trainer: the port of
mec_tpu/training/train_fusion_rf.py.

Fits sklearn's RandomForestClassifier on the concatenated per-modality
softmax vectors (21 features for 7 emotions x 3 modalities) of the
fusion trainer's synthetic distribution (or of real triples with
--manifest), then converts the fitted forest into the dense arrays that
models/forest.forest_apply walks on the device. sklearn (and joblib) are
imported only here, when train runs; where they are missing (the card's
machine has no sklearn) train raises an ImportError naming the package.

Artifacts, the JAX trainer's:
  fusion_rf.pkl   the fitted sklearn forest (joblib)
  fusion_rf.mecp  the dense-array forest the engine serves with
                  MEC_FUSION_MODE=rf (meta: kind, depth, n_features,
                  n_classes, classes, val_acc)
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store
from mec_tpu_torch.models import forest
from mec_tpu_torch.training import common, metrics
from mec_tpu_torch.training.train_fusion import (extract_real_features,
                                                 generate_synthetic_data)


def softmax_features(s_p: np.ndarray, t_p: np.ndarray, i_p: np.ndarray
                     ) -> np.ndarray:
    """Concat the three per-modality softmax vectors -> (B, 21)."""
    return np.concatenate([s_p, t_p, i_p], axis=1).astype(np.float32)


def train(num_samples: int = 10000, n_estimators: int = 100,
          max_depth: Optional[int] = 12, models_dir: Optional[str] = None,
          seed: int = 42, dataset=None, verbose: bool = True):
    log = print if verbose else (lambda *_a, **_k: None)
    try:
        import joblib
        from sklearn.ensemble import RandomForestClassifier
    except ImportError as e:
        raise ImportError(
            f'train_fusion_rf needs scikit-learn (the sklearn package, '
            f'with joblib), which is not installed here: {e}') from e

    if dataset is None:
        log('Generating synthetic training data...')
        dataset = generate_synthetic_data(num_samples, seed)
    _s_f, _t_f, _i_f, s_p, t_p, i_p, labels = dataset
    x = softmax_features(s_p, t_p, i_p)

    tr, va = metrics.train_test_split_stratified(len(labels), labels,
                                                 0.15, seed=42)
    rf = RandomForestClassifier(n_estimators=n_estimators,
                                max_depth=max_depth, random_state=seed,
                                n_jobs=-1)
    rf.fit(x[tr], labels[tr])
    preds = rf.predict(x[va]).astype(np.int64)
    val_acc = metrics.accuracy(labels[va], preds)
    log(f'val accuracy: {val_acc:.4f} ({n_estimators} trees, '
        f'max_depth={max_depth})')
    log('\n' + metrics.classification_report(labels[va], preds,
                                             Config.EMOTIONS))

    common.record_metrics('fusion_rf', val_acc, labels[va], preds)
    models_dir = models_dir or os.path.dirname(Config.FUSION_MODEL_PATH)
    os.makedirs(models_dir, exist_ok=True)
    pkl = os.path.join(models_dir, 'fusion_rf.pkl')
    joblib.dump(rf, pkl)
    arrays, meta = forest.from_sklearn(rf)
    meta['val_acc'] = float(val_acc)
    nat = os.path.join(models_dir, 'fusion_rf.mecp')
    store.save_params(nat, {'forest': arrays}, meta=meta)
    log(f'Saved {pkl} and {nat}')
    return rf, arrays, meta


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Train the random-forest fusion variant')
    p.add_argument('--num-samples', type=int, default=10000)
    p.add_argument('--n-estimators', type=int, default=100)
    p.add_argument('--max-depth', type=int, default=12,
                   help='0 = unbounded (sklearn default)')
    p.add_argument('--models-dir', default=None)
    p.add_argument('--manifest', default=None,
                   help='CSV of audio_path,text,image_path,label rows: '
                        'train on real encoder softmax outputs instead '
                        'of synthetic data')
    p.add_argument('--device', default='cuda',
                   help='device of the engine that extracts --manifest '
                        "features (default cuda); the forest fits on the "
                        'host')
    args = p.parse_args(argv)
    dataset = (extract_real_features(args.manifest, args.models_dir,
                                     device=args.device)
               if args.manifest else None)
    train(args.num_samples, args.n_estimators,
          args.max_depth or None, args.models_dir, dataset=dataset)


if __name__ == '__main__':
    main()
