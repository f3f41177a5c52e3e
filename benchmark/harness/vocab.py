"""The benchmark's WordPiece vocabulary: 30,522 entries, BERT-base-uncased's
size, made from a fixed seed so that every run tokenises alike.

Layout: the five special tokens at ids 0-4 (where the weight trees zero
their embedding rows), single characters and punctuation, their `##`
continuations, common English suffixes as `##` pieces, then seeded
pseudo-words built from English-like syllables (shortest first, which is
also their frequency rank) and `##` syllable pieces up to the size. A
sentence of whole words then tokenises at about one token a word, and an
out-of-vocabulary word (two words run together) at two to four.
"""

from __future__ import annotations

import string
from typing import Dict, List, Tuple

import numpy as np

SPECIALS = ('[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]')
PUNCT = tuple(".,!?'-;:")
SUFFIXES = ('s', 'es', 'ed', 'ing', 'ly', 'er', 'est', 'ness', 'ful',
            'less', 'ment', 'able', 'tion', 'y', 'ish', 'ist', 'ism')
_ONSETS = ('', 'b', 'c', 'd', 'f', 'g', 'h', 'j', 'k', 'l', 'm', 'n', 'p',
           'r', 's', 't', 'v', 'w', 'y', 'z', 'bl', 'br', 'ch', 'cl', 'cr',
           'dr', 'fl', 'fr', 'gl', 'gr', 'pl', 'pr', 'sh', 'sl', 'sm', 'sn',
           'sp', 'st', 'str', 'th', 'tr', 'wh', 'qu', 'sc')
_VOWELS = ('a', 'e', 'i', 'o', 'u', 'ai', 'ea', 'ee', 'oo', 'ou', 'ie',
           'oa', 'y')
_CODAS = ('', '', '', 'n', 'r', 's', 't', 'l', 'm', 'nd', 'ng', 'nt', 'st',
          'ck', 'rd', 'th', 'll', 'ss', 'p', 'd', 'k')


def _syllables(rng: np.random.Generator, n: int) -> List[str]:
    o = rng.integers(0, len(_ONSETS), n)
    v = rng.integers(0, len(_VOWELS), n)
    c = rng.integers(0, len(_CODAS), n)
    return [_ONSETS[a] + _VOWELS[b] + _CODAS[d] for a, b, d in zip(o, v, c)]


def build_vocab(size: int = 30522, whole_share: float = 0.8,
                seed: int = 30522) -> Tuple[Dict[str, int], List[str]]:
    """-> ({token: id}, whole words in rank order). Deterministic."""
    rng = np.random.default_rng(seed)
    tokens: List[str] = list(SPECIALS)
    chars = list(string.ascii_lowercase + string.digits)
    tokens += chars + list(PUNCT)
    tokens += ['##' + c for c in chars]
    tokens += ['##' + s for s in SUFFIXES if len(s) > 1]
    seen = set(tokens)
    n_whole = int(whole_share * (size - len(tokens)))
    words: List[str] = []
    while len(words) < n_whole:
        k = rng.choice([1, 2, 2, 3, 3, 4], 4096)
        sy = _syllables(rng, int(k.sum()))
        pos = 0
        for n in k:
            w = ''.join(sy[pos:pos + n])
            pos += n
            if len(w) >= 2 and w not in seen:
                seen.add(w)
                words.append(w)
                if len(words) == n_whole:
                    break
    # shorter words are the more frequent ones, as in English
    words.sort(key=len)
    tokens += words
    while len(tokens) < size:
        for s in _syllables(rng, 4096):
            piece = '##' + s
            if piece not in seen:
                seen.add(piece)
                tokens.append(piece)
                if len(tokens) == size:
                    break
    return {t: i for i, t in enumerate(tokens)}, words
