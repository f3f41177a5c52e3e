"""Speech emotion DNN, plain torch.nn.

Port of mec_tpu/models/speech_dnn.py (the reference Keras architecture):
five blocks of Linear -> BatchNorm1d -> ReLU with widths
512/512/256/128/64, then Linear(7) and softmax. Keras BatchNorm eps 1e-3
is kept (Keras momentum 0.99 is torch momentum 0.01; it only matters in
training). Dropout is omitted: this module serves inference, where
dropout is the identity.

forward returns (probs (B, 7), penult (B, 64)): the post-ReLU output of
block 5 is the fusion feature, so it costs no second pass. This is the
plain model; the serving path runs the fused kernel of
ops/speech_kernels.py (BatchNorm folded) and the tests hold the two
against each other and against the Flax model.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


class SpeechDNN(nn.Module):
    def __init__(self, in_dim: int = 56, num_classes: int = 7,
                 widths: Sequence[int] = (512, 512, 256, 128, 64)):
        super().__init__()
        dims = (in_dim,) + tuple(widths)
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.bn = nn.ModuleList(nn.BatchNorm1d(w, eps=1e-3, momentum=0.01)
                                for w in widths)
        self.out = nn.Linear(dims[-1], num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, 56) standardized features -> (probs, penult)."""
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x)))
        logits = self.out(x)
        return torch.softmax(logits.float(), dim=-1), x.float()
