"""Keras-Tokenizer-compatible word tokenizer for the Bi-LSTM text path.

A copy of mec_tpu/text/keras_tokenizer.py (importing mec_tpu imports
jax); tests/test_torch_lstm.py pins it to the original.

The reference trains with keras.preprocessing.text.Tokenizer(num_words=10000,
oov_token='<OOV>') and serves by unpickling it
(reference model_training/train_lstm_text_model.py:148-152,
reference inference/text_lstm_inference.py:30-45). This class reproduces
Keras semantics (default filters, lower, split, count-ordered word_index
with OOV at 1, num_words cutoff, post/post padding) with no Keras
dependency, can ingest a pickled Keras tokenizer's state (the .pkl path
imports pickle when it is taken), and persists as plain JSON.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

KERAS_FILTERS = '!"#$%&()*+,-./:;<=>?@[\\]^_`{|}~\t\n'


class KerasTokenizer:
    def __init__(self, num_words: Optional[int] = 10000,
                 oov_token: Optional[str] = '<OOV>',
                 filters: str = KERAS_FILTERS, lower: bool = True,
                 split: str = ' '):
        self.num_words = num_words
        self.oov_token = oov_token
        self.filters = filters
        self.lower = lower
        self.split = split
        self.word_counts: "OrderedDict[str, int]" = OrderedDict()
        self.word_index: Dict[str, int] = {}
        self.index_word: Dict[int, str] = {}

    # ------------------------------------------------------------------
    def _text_to_words(self, text: str) -> List[str]:
        if self.lower:
            text = text.lower()
        table = str.maketrans({c: self.split for c in self.filters})
        text = text.translate(table)
        return [w for w in text.split(self.split) if w]

    def fit_on_texts(self, texts) -> None:
        for text in texts:
            for w in self._text_to_words(text):
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
        # Keras sorts by count desc, stable in insertion order for ties,
        # then inserts the OOV token at index 1.
        wcounts = sorted(self.word_counts.items(),
                         key=lambda kv: kv[1], reverse=True)
        vocab = [w for w, _ in wcounts]
        if self.oov_token is not None:
            vocab.insert(0, self.oov_token)
        self.word_index = {w: i + 1 for i, w in enumerate(vocab)}
        self.index_word = {i: w for w, i in self.word_index.items()}

    def texts_to_sequences(self, texts) -> List[List[int]]:
        oov_idx = self.word_index.get(self.oov_token) if self.oov_token else None
        out = []
        for text in texts:
            seq = []
            for w in self._text_to_words(text):
                i = self.word_index.get(w)
                if i is not None and (self.num_words is None
                                      or i < self.num_words):
                    seq.append(i)
                elif oov_idx is not None:
                    seq.append(oov_idx)
            out.append(seq)
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def pad_sequences(seqs: List[List[int]], maxlen: int,
                      padding: str = 'post', truncating: str = 'post'
                      ) -> np.ndarray:
        out = np.zeros((len(seqs), maxlen), dtype=np.int32)
        for i, s in enumerate(seqs):
            if len(s) > maxlen:
                s = s[:maxlen] if truncating == 'post' else s[-maxlen:]
            if padding == 'post':
                out[i, :len(s)] = s
            else:
                out[i, maxlen - len(s):] = s
        return out

    def encode_batch(self, texts, maxlen: int = 128) -> np.ndarray:
        return self.pad_sequences(self.texts_to_sequences(texts), maxlen)

    # ------------------------------------------------------------------
    def to_json_file(self, path: str) -> None:
        with open(path, 'w') as f:
            json.dump({'num_words': self.num_words,
                       'oov_token': self.oov_token,
                       'filters': self.filters, 'lower': self.lower,
                       'split': self.split,
                       'word_index': self.word_index}, f)

    @classmethod
    def from_json_file(cls, path: str) -> 'KerasTokenizer':
        with open(path) as f:
            d = json.load(f)
        t = cls(num_words=d['num_words'], oov_token=d['oov_token'],
                filters=d['filters'], lower=d['lower'], split=d['split'])
        t.word_index = {k: int(v) for k, v in d['word_index'].items()}
        t.index_word = {i: w for w, i in t.word_index.items()}
        return t

    @classmethod
    def from_keras_pickle(cls, path: str) -> 'KerasTokenizer':
        """Ingest a pickled keras Tokenizer (reference artifact format)."""
        import pickle
        with open(path, 'rb') as f:
            kt = pickle.load(f)
        t = cls(num_words=getattr(kt, 'num_words', None),
                oov_token=getattr(kt, 'oov_token', None),
                filters=getattr(kt, 'filters', KERAS_FILTERS),
                lower=getattr(kt, 'lower', True),
                split=getattr(kt, 'split', ' '))
        t.word_index = dict(kt.word_index)
        t.index_word = {i: w for w, i in t.word_index.items()}
        return t

    @classmethod
    def load(cls, path: str) -> 'KerasTokenizer':
        if path.endswith('.json'):
            return cls.from_json_file(path)
        return cls.from_keras_pickle(path)
