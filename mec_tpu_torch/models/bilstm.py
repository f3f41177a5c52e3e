"""Bi-LSTM text emotion model: the port of mec_tpu/models/bilstm.py.

The reference Keras architecture (reference
model_training/train_lstm_text_model.py:96-122):

    Embedding(vocab 10000, 128) -> SpatialDropout1D(0.3)
    -> Bidirectional(LSTM(128, return_sequences=True))
    -> Bidirectional(LSTM(64))
    -> Dense(128) ReLU -> Dropout(0.5) -> Dense(64) ReLU -> Dropout(0.3)
    -> Dense(7) softmax

Keras LSTM semantics, as the Flax KerasLSTM computes them: gate order i,
f, c~, o (torch's order too), sigmoid gates, tanh cell, no masking. Each
Bidirectional layer is one bidirectional torch.nn.LSTM (cuDNN on the
card in fp32): its backward direction runs over the reversed sequence
and its sequence output is re-aligned to the input's time order, as
Keras and the Flax pair of KerasLSTMs do; without return_sequences the
layer returns the two final hidden states side by side.

Keras has one bias per direction, torch two (bias_ih, bias_hh): the
Keras bias is bias_ih, and bias_hh stays zero and takes no gradient
(requires_grad False), since a trainable bias_hh would get the same
gradient and double the bias's Adam step
(convert/from_jax.lstm_state_from_jax; convert/to_jax writes
bias_ih + bias_hh).

Training: SpatialDropout1D drops whole embedding channels, one mask per
(batch, channel) broadcast over time (Flax Dropout broadcast_dims=(1,)),
and the head's dropouts are 0.5 and 0.3; all follow module.training and
the default generator. forward returns (probs (B, C) f32, the post-ReLU
dense_2 output (B, 64) f32). In bf16 the embeddings, LSTMs and Dense
layers run in bf16 and the softmax in fp32, as the Flax model with
dtype=bfloat16 does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mec_tpu_torch.models.bert import Dense


class BiLSTM(nn.LSTM):
    """Keras Bidirectional(LSTM(units, return_sequences), merge 'concat')
    on (B, T, D) inputs."""

    def __init__(self, input_size: int, units: int, return_sequences: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__(input_size, units, batch_first=True,
                         bidirectional=True, dtype=dtype)
        self.return_sequences = return_sequences
        for name in ('bias_hh_l0', 'bias_hh_l0_reverse'):
            b = getattr(self, name)
            with torch.no_grad():
                b.zero_()
            b.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq, (h, _c) = super().forward(x)
        if self.return_sequences:
            return seq
        return torch.cat([h[0], h[1]], dim=-1)


class BiLSTMTextModel(nn.Module):
    def __init__(self, vocab_size: int = 10000, embed_dim: int = 128,
                 lstm_units: Tuple[int, int] = (128, 64),
                 dense_units: Tuple[int, int] = (128, 64),
                 num_classes: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_dim, dtype=dtype)
        self.bilstm_1 = BiLSTM(embed_dim, lstm_units[0], True, dtype)
        self.bilstm_2 = BiLSTM(2 * lstm_units[0], lstm_units[1], False, dtype)
        self.dense_1 = Dense(2 * lstm_units[1], dense_units[0], dtype=dtype)
        self.dense_2 = Dense(dense_units[0], dense_units[1], dtype=dtype)
        self.output = Dense(dense_units[1], num_classes, dtype=dtype)
        self.spatial_dropout = nn.Dropout(0.3)
        self.dropout_1 = nn.Dropout(0.5)
        self.dropout_2 = nn.Dropout(0.3)
        self.eval()    # the Flax models' train=False default

    def forward(self, token_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) integer ids -> (probs (B, C) f32, penult (B, 64) f32)."""
        x = self.embedding(token_ids.long())
        if self.training:
            B, _T, C = x.shape
            x = x * self.spatial_dropout(x.new_ones(B, 1, C))
        x = self.bilstm_2(self.bilstm_1(x))
        x = self.dropout_1(F.relu(self.dense_1(x)))
        penult = F.relu(self.dense_2(x))
        logits = self.output(self.dropout_2(penult))
        return torch.softmax(logits.float(), dim=-1), penult.float()
