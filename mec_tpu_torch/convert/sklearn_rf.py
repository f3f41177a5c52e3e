"""sklearn RandomForest -> the port's dense tree-ensemble arrays.

A copy of mec_tpu/convert/sklearn_rf.py over models/forest.py's
from_sklearn (itself pinned to the JAX package's): a deployment that
trained the random-forest fusion holds a joblib/pickle
RandomForestClassifier, turned here into the arrays forest_apply walks
on the device and cached as a .mecp. Unpickling needs joblib and
sklearn (convert/_imports.py).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from mec_tpu_torch.convert._imports import require
from mec_tpu_torch.models import forest


def convert_fusion_rf(pkl_path: str) -> Tuple[Dict[str, Any],
                                              Dict[str, Any]]:
    """fusion_rf.pkl (joblib or pickle) -> ({'forest': arrays}, meta)."""
    joblib = require('joblib', f'reading {pkl_path}')
    rf = joblib.load(pkl_path)
    if not hasattr(rf, 'estimators_'):
        raise ValueError(f'{pkl_path} is not a fitted sklearn forest')
    arrays, meta = forest.from_sklearn(rf)
    return {'forest': arrays}, meta
