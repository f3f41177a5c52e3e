"""BERT-uncased tokenisation for ASCII text: lower-case, split on
whitespace, split punctuation (ASCII 33-47, 58-64, 91-96, 123-126) into
tokens of their own, then greedy longest-match WordPiece (continuations
prefixed `##`; a word with no match, or over 100 characters, is
[UNK]); [CLS] ... [SEP], cut to max_length, padded with [PAD]."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_PUNCT = set(chr(c) for c in list(range(33, 48)) + list(range(58, 65))
             + list(range(91, 97)) + list(range(123, 127)))


def basic(text: str) -> List[str]:
    out: List[str] = []
    for word in text.lower().split():
        cur = ''
        for ch in word:
            if ch in _PUNCT:
                if cur:
                    out.append(cur)
                out.append(ch)
                cur = ''
            else:
                cur += ch
        if cur:
            out.append(cur)
    return out


def pieces(word: str, vocab: Dict[str, int]) -> List[str]:
    if len(word) > 100:
        return ['[UNK]']
    out, start = [], 0
    while start < len(word):
        for end in range(len(word), start, -1):
            sub = word[start:end] if start == 0 else '##' + word[start:end]
            if sub in vocab:
                out.append(sub)
                start = end
                break
        else:
            return ['[UNK]']
    return out


def encode(texts: Sequence[str], vocab: Dict[str, int], max_length: int
           ) -> Tuple[np.ndarray, np.ndarray]:
    ids = np.full((len(texts), max_length), vocab['[PAD]'], np.int64)
    mask = np.zeros((len(texts), max_length), np.int64)
    for i, t in enumerate(texts):
        toks = [p for w in basic(t) for p in pieces(w, vocab)]
        row = ([vocab['[CLS]']] + [vocab[p] for p in toks[:max_length - 2]]
               + [vocab['[SEP]']])
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask
