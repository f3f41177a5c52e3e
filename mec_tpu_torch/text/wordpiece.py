"""Self-contained BERT WordPiece tokenizer: a copy of
mec_tpu/text/wordpiece.py (importing mec_tpu imports jax, which the
card's machine lacks). Pure Python: basic tokenization (cleaning, CJK
spacing, lower-casing, accent stripping, punctuation splitting) and
greedy longest-match WordPiece, with BertTokenizer's
`max_length, padding='max_length', truncation=True` encoding.
tests/test_torch_text.py pins the copy to the original. The C++ fast
path for ASCII batches is native/tokenizer.py::accelerate (the serving
engine applies it to its BERT tokenizer); this encoder stays its meaning.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np


def _is_whitespace(ch: str) -> bool:
    if ch in (' ', '\t', '\n', '\r'):
        return True
    return unicodedata.category(ch) == 'Zs'


def _is_control(ch: str) -> bool:
    if ch in ('\t', '\n', '\r'):
        return False
    return unicodedata.category(ch).startswith('C')


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or \
            (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith('P')


def _is_chinese_char(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF) or
            (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F) or
            (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF) or
            (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 unk_token: str = '[UNK]', cls_token: str = '[CLS]',
                 sep_token: str = '[SEP]', pad_token: str = '[PAD]',
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab[unk_token]
        self.max_chars_per_word = max_chars_per_word

    # ------------------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> 'WordPieceTokenizer':
        vocab: Dict[str, int] = {}
        with open(path, encoding='utf-8') as f:
            for i, line in enumerate(f):
                tok = line.rstrip('\n')
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> Optional['WordPieceTokenizer']:
        """Load vocab.txt from a save_pretrained directory (or None)."""
        path = os.path.join(model_dir, 'vocab.txt')
        if not os.path.exists(path):
            return None
        lower = True
        import json
        cfg_path = os.path.join(model_dir, 'tokenizer_config.json')
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                lower = json.load(f).get('do_lower_case', True)
        return cls.from_vocab_file(path, do_lower_case=lower)

    # ------------------------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(' ' if _is_whitespace(ch) else ch)
        return ''.join(out)

    def _tokenize_chinese(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_chinese_char(ord(ch)):
                out.extend([' ', ch, ' '])
            else:
                out.append(ch)
        return ''.join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return ''.join(ch for ch in unicodedata.normalize('NFD', text)
                       if unicodedata.category(ch) != 'Mn')

    @staticmethod
    def _split_on_punc(token: str) -> List[str]:
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                    start_new = False
                pieces[-1].append(ch)
        return [''.join(p) for p in pieces]

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._tokenize_chinese(self._clean(text))
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_on_punc(tok))
        return [t for t in tokens if t]

    def wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_chars_per_word:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = '##' + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            out.append(piece)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    # ------------------------------------------------------------------
    def encode(self, text: str, max_length: int = 128
               ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (input_ids, attention_mask), each (max_length,) int32.

        Matches tokenizer(text, add_special_tokens=True, max_length=L,
        padding='max_length', truncation=True).
        """
        toks = self.tokenize(text)[: max_length - 2]
        ids = [self.cls_id] + [self.vocab.get(t, self.unk_id) for t in toks] \
            + [self.sep_id]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids += [self.pad_id] * pad
        mask += [0] * pad
        return (np.asarray(ids, dtype=np.int32),
                np.asarray(mask, dtype=np.int32))

    def encode_batch(self, texts: List[str], max_length: int = 128
                     ) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(t, max_length) for t in texts]
        return (np.stack([p[0] for p in pairs]),
                np.stack([p[1] for p in pairs]))
