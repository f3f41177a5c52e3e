"""The engine's Moonlight-16B-A3B text leg (text_arch='moonlight').

The leg takes a tree of tensors already on the engine's device
(models/moonlight.py's layout) and keeps them as they are: no host copy,
no float32 copy, no conversion. Texts are tokenized by WordPiece (the
port's one tokenizer) into right-padded ids, sliced to a sequence bucket
by the engine as for BERT.

forward(ids, mask) is the leg's part of a device step: the packed
[probs | final-normed hidden state at the last real token] rows, in
float32 (as BERT's), and the step's routing counters (2,) int32, summed over
the expert layers: [experts given a real token, real token-expert
pairs]. The engine carries the counters out of the tri-modal step in
its packed rows (no extra sync) and records their means over the expert
layers on the StageTimer as text.moe.experts_touched and
text.moe.routed_pairs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from mec_tpu_torch.models.moonlight import FIELDS, MoonlightForClassification
from mec_tpu_torch.native.tokenizer import accelerate
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer

# what the leg reports per dispatch (StageTimer record names)
COUNTER_NAMES = ('text.moe.experts_touched', 'text.moe.routed_pairs')


def _device_tensors(tree, device: torch.device, dtype: torch.dtype,
                    path: str = '') -> None:
    """Raise unless every leaf is a tensor on `device` in `dtype`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _device_tensors(v, device, dtype, f'{path}/{k}')
        return
    if (not isinstance(tree, torch.Tensor) or tree.dtype != dtype
            or tree.device.type != device.type
            or device.index not in (None, tree.device.index)):
        got = (f'{tree.dtype} on {tree.device}'
               if isinstance(tree, torch.Tensor) else type(tree).__name__)
        raise TypeError(f'moonlight leaf {path}: expected a {dtype} tensor '
                        f'on {device}, got {got}')


class MoonlightText:
    arch = 'moonlight'

    def __init__(self, variables: Dict, kwargs: Dict, vocab,
                 device: torch.device, dtype: torch.dtype):
        missing = [k for k in FIELDS if k not in kwargs]
        if missing:
            raise ValueError(f'moonlight text_kwargs lack {missing}')
        _device_tensors(variables, device, dtype)
        self.tokenizer = (vocab if isinstance(vocab, WordPieceTokenizer)
                          else WordPieceTokenizer(dict(vocab)))
        accelerate(self.tokenizer)
        self.model = MoonlightForClassification(variables, kwargs)
        self.feature_dim = kwargs['hidden_size']

    def to(self, device: torch.device) -> 'MoonlightText':
        """A replica's leg on `device`: the tensors copied there."""
        def move(t):
            return ({k: move(v) for k, v in t.items()} if isinstance(t, dict)
                    else t.to(device))
        rep = object.__new__(MoonlightText)
        rep.tokenizer, rep.feature_dim = self.tokenizer, self.feature_dim
        rep.model = MoonlightForClassification(move(self.model.tree),
                                               self.model.cfg)
        return rep

    def forward(self, ids: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits, feat, counts = self.model(ids, mask)
        return torch.cat([torch.softmax(logits.float(), -1), feat.float()],
                         -1), counts

    def counter_means(self, summed) -> Dict[str, float]:
        """The StageTimer records of one dispatch from its summed counters:
        each a mean over the expert layers."""
        n = self.model.n_moe
        return {name: float(v) / n for name, v in zip(COUNTER_NAMES, summed)}
