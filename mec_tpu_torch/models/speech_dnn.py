"""Speech emotion DNN, plain torch.nn.

Port of mec_tpu/models/speech_dnn.py (the reference Keras architecture):
five blocks of Linear -> BatchNorm1d -> ReLU with widths
512/512/256/128/64, then Linear(7) and softmax. Keras BatchNorm eps 1e-3
is kept (Keras momentum 0.99 is torch momentum 0.01). In training mode
each block ends in dropout (0.4/0.4/0.3/0.2/0.1) and the BatchNorms take
Flax's statistics update (models/batchnorm.py: the biased batch
variance, not torch's unbiased one).

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

from mec_tpu_torch.models.batchnorm import BatchNorm1d, wide


class SpeechDNN(nn.Module):
    def __init__(self, in_dim: int = 56, num_classes: int = 7,
                 widths: Sequence[int] = (512, 512, 256, 128, 64),
                 dropout_rates: Sequence[float] = (0.4, 0.4, 0.3, 0.2, 0.1)):
        super().__init__()
        dims = (in_dim,) + tuple(widths)
        self.dense = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(dims[:-1], dims[1:]))
        self.bn = nn.ModuleList(BatchNorm1d(w, eps=1e-3, momentum=0.01)
                                for w in widths)
        self.dropout = nn.ModuleList(nn.Dropout(r) for r in dropout_rates)
        self.out = nn.Linear(dims[-1], num_classes)
        self.eval()    # the Flax models' train=False default

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, 56) standardized features -> (probs, penult)."""
        for dense, bn, drop in zip(self.dense, self.bn, self.dropout):
            x = drop(torch.relu(bn(dense(x))))
        logits = self.out(x)
        return torch.softmax(wide(logits), dim=-1), wide(x)
