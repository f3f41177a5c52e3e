"""The traffic: the same seed gives the same requests and files; seeds
change contents and order but not sizes; the drawn sizes follow the
mix's stated distributions; the vocabulary tokenises at English-like
rates."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness import traffic as tr
from benchmark.harness.vocab import SPECIALS, build_vocab
from benchmark.reference import wordpiece
from benchmark.tests.tiny import _tiny_mix, open_mix

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def vocab():
    return build_vocab()


def _build(tmp_path, name, seed, vocab, seconds=2.0, tag=''):
    d = tmp_path / f'{name}-{seed}{tag}'
    d.mkdir()
    mix = open_mix() if name == 'open' else _tiny_mix(name)
    return tr.build(mix, seed, seconds, vocab[1], str(d),
                    torch.device('cpu'))


def _digest(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize('name', ['open', 'one_client', 'saturated'])
def test_same_seed_same_requests_and_files(tmp_path, vocab, name):
    a = _build(tmp_path, name, 2 ** 31 + 11, vocab)
    b = _build(tmp_path, name, 2 ** 31 + 11, vocab, tag='b')
    assert [(r.text, os.path.basename(r.audio_path),
             os.path.basename(r.image_path), r.due) for r in a.timed] == \
        [(r.text, os.path.basename(r.audio_path),
          os.path.basename(r.image_path), r.due) for r in b.timed]
    for ra, rb in zip(a.timed[:3], b.timed[:3]):
        assert _digest(ra.audio_path) == _digest(rb.audio_path)
        assert _digest(ra.image_path) == _digest(rb.image_path)


def test_seeds_keep_sizes_and_change_contents(tmp_path, vocab):
    a = _build(tmp_path, 'open', 1, vocab, seconds=20.0)
    b = _build(tmp_path, 'open', 2, vocab, seconds=20.0)
    assert sorted(r.n_words for r in a.timed) == \
        sorted(r.n_words for r in b.timed)
    assert sorted(a.clip_seconds) == sorted(b.clip_seconds)
    assert len(a.timed) == len(b.timed) == 120       # 6 req/s x 20 s
    assert [r.due for r in a.timed] == [r.due for r in b.timed]
    assert [r.text for r in a.timed] != [r.text for r in b.timed]
    assert [r.n_words for r in a.timed] != [r.n_words for r in b.timed]


def test_arrivals_fill_the_window():
    due = tr.arrival_times(10, 30, 99)
    assert len(due) == 300 and due[0] == 0 and due[-1] < 30
    gaps = np.diff(due)
    assert abs(gaps.mean() - 0.1) < 0.01
    # exponential: the spread of the gaps is about their mean
    assert 0.8 < gaps.std() / gaps.mean() < 1.2


def test_word_counts_follow_the_mix():
    with open(os.path.join(BENCH, 'traffic', 'one_client.json')) as f:
        text = json.load(f)['text']
    n = tr.word_counts(text, 40000, np.random.default_rng(0))
    assert 11 <= np.median(n) <= 13.5
    tail = np.mean(n >= 40)
    assert 0.09 <= tail <= 0.125
    assert n.max() <= 120 and n.min() >= 1


def test_zipf_ranks():
    r = tr.zipf_ranks(200000, 1000, 1.1, np.random.default_rng(0))
    f = np.bincount(r, minlength=1000) / len(r)
    # P(rank 1) / P(rank 10) = 10 ** 1.1
    assert abs(f[0] / f[9] - 10 ** 1.1) / 10 ** 1.1 < 0.1
    assert r.max() < 1000


def test_vocab_and_token_rates(vocab):
    ids, words = vocab
    assert len(ids) == 30522
    assert [t for t, i in sorted(ids.items(), key=lambda kv: kv[1])[:5]] \
        == list(SPECIALS)
    assert sorted(ids.values()) == list(range(30522))
    rng = np.random.default_rng(5)
    with open(os.path.join(BENCH, 'traffic', 'one_client.json')) as f:
        text = json.load(f)['text']
    counts = tr.word_counts(text, 400, rng)
    texts = tr.make_texts(text, counts, words, rng)
    assert all(t.isascii() for t in texts)
    toks = [len([p for w in wordpiece.basic(t) for p in
                 wordpiece.pieces(w, ids)]) for t in texts]
    # whole words one token, punctuation one, out-of-vocabulary words 2-4
    rate = sum(toks) / counts.sum()
    assert 1.05 <= rate <= 1.6, rate
    unk = sum(p == '[UNK]' for t in texts for w in wordpiece.basic(t)
              for p in wordpiece.pieces(w, ids))
    assert unk == 0
