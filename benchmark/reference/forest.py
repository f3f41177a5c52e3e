"""The random-forest fusion (sklearn's predict_proba): each tree walks
from its root, left where x[feature] <= threshold, to a leaf; the
probabilities are the mean of the leaves' class distributions. Walked
one request at a time in numpy.

Judged on the program's own input: the forest reads the three modality
probabilities that the request returned (which the other stages judge
against the reference), so that a fused answer is compared with the
forest's answer to the same 21 numbers. Stage 'forest' (float32; the
control walks on bfloat16 inputs)."""

from __future__ import annotations

import numpy as np
import torch

INPUT = 'program'


def forward(arrays, probs, prec):
    """probs: three (B, 7) tensors -> (B, 7)."""
    x = prec.values(torch.cat(probs, -1), 'forest').double().cpu().numpy()
    feat, thr = arrays['feature'], arrays['threshold'].astype(np.float64)
    left, right, proba = arrays['left'], arrays['right'], arrays['proba']
    out = np.zeros((x.shape[0], proba.shape[2]))
    for b in range(x.shape[0]):
        for t in range(feat.shape[0]):
            node = 0
            while left[t, node] != node:
                node = (left[t, node] if x[b, feat[t, node]] <= thr[t, node]
                        else right[t, node])
            out[b] += proba[t, node]
    return torch.as_tensor(out / feat.shape[0], dtype=torch.float32)
