"""The training package's copies of numpy-only JAX-package code, pinned
bit for bit: training/metrics.py, training/data.py's text loader, image
listing, image loading and augmentation, training/corpora.py (the
end-to-end walkthrough's corpora and tokenizer),
train_fusion.generate_synthetic_data, train_fusion_rf.softmax_features
and models/forest.from_sklearn. The speech loader is the one piece that
computes on the device: its features are held to the JAX loader's within
1e-4 + 2e-6 |ref|, the fp32 parity contract of tests/test_torch_parity.py
(its relative part covers the centroid and rolloff in Hz; measured 1.7e-7
relative), and its labels exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mec_tpu.models import forest as jforest
from mec_tpu.training import data as jdata
from mec_tpu.training import metrics as jmetrics
from mec_tpu.training import train_fusion as jfusion
from mec_tpu.training import train_fusion_rf as jrf
from mec_tpu_torch.models import forest
from mec_tpu_torch.training import (corpora, data, metrics, train_fusion,
                                    train_fusion_rf)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples'))
import end_to_end  # noqa: E402


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The tier-1 run has six workers on the CPU: torch's default of one
    thread a core in each of them makes these small-op workloads spin on
    each other, so this file keeps torch at two threads and restores
    the count afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_metrics_copy():
    rng = np.random.RandomState(0)
    y, p = rng.randint(0, 7, 60), rng.randint(0, 7, 60)
    y[:7] = np.arange(7)
    for fn, args in (('accuracy', (y, p)), ('confusion_matrix', (y, p, 7)),
                     ('precision_recall_f1', (y, p, 7)),
                     ('train_test_split_stratified', (60, y, 0.2, 3))):
        _same(getattr(metrics, fn)(*args), getattr(jmetrics, fn)(*args))
    names = ['happy', 'sad', 'angry', 'fear', 'disgust', 'surprise',
             'neutral']
    assert metrics.classification_report(y, p, names) == \
        jmetrics.classification_report(y, p, names)


@pytest.mark.parametrize('body', [
    'text;label\ni am so happy;joy\nso sad today;sadness\nscared;3\n'
    'mad world;anger\nwho knows;unknown\nlove it;love\n',
    'sentence,label\n"hello, there",happy\nfurious!,angry\nmeh,6\n',
    'calm waters\tcalm\nyikes\tsurprised\ngross\tdisgusted\n'])
def test_text_loader_copy(tmp_path, body):
    path = tmp_path / 'd.csv'
    path.write_text(body)
    for fold in (True, False):
        _same(data.load_text_dataset(str(path), fold, verbose=False),
              jdata.load_text_dataset(str(path), fold, verbose=False))


def test_image_listing_loading_and_augmentation_copy(tmp_path):
    rng = np.random.RandomState(1)
    for cls in ('happy', 'Sad', 'notanemotion'):
        os.makedirs(tmp_path / cls)
        for i, ext in enumerate(('png', 'jpg', 'txt')):
            Image.fromarray(rng.randint(0, 256, (20, 30, 3), np.uint8)).save(
                tmp_path / cls / f'{i}.{ext}', format='PNG')
    paths, labels = data.list_image_dataset(str(tmp_path), verbose=False)
    _same((paths, labels),
          jdata.list_image_dataset(str(tmp_path), verbose=False))
    imgs = data.load_images_uint8(paths, 24, verbose=False)
    _same(imgs, jdata.load_images_uint8(paths, 24, verbose=False))
    _same(data.augment_images_uint8(imgs, np.random.RandomState(9)),
          jdata.augment_images_uint8(imgs, np.random.RandomState(9)))


def test_corpora_copy(tmp_path):
    corpora.make_speech_corpus(str(tmp_path / 'mine'), per_class=1)
    end_to_end.make_speech_corpus(str(tmp_path / 'theirs'), per_class=1)
    for emotion in end_to_end.EMOTION_TONES:
        assert (tmp_path / 'mine' / emotion / '0.wav').read_bytes() == \
            (tmp_path / 'theirs' / emotion / '0.wav').read_bytes()
    texts, labels = corpora.make_text_corpus(per_class=4)
    _same((texts.tolist(), labels),
          [a.tolist() if a.dtype == object else a
           for a in end_to_end.make_text_corpus(per_class=4)])
    _same(corpora.make_image_corpus(img_size=16, per_class=2),
          end_to_end.make_image_corpus(img_size=16, per_class=2))
    assert corpora.make_bert_tokenizer(texts).vocab == \
        end_to_end.make_bert_tokenizer(texts).vocab
    assert corpora.EMOTION_PHRASES == end_to_end.EMOTION_PHRASES
    assert corpora.EMOTION_HUES == end_to_end.EMOTION_HUES


def test_fusion_data_and_forest_copies():
    for kw in ({}, {'dims': {'speech': 8, 'text': 16, 'image': 4}}):
        _same(train_fusion.generate_synthetic_data(50, 3, **kw),
              jfusion.generate_synthetic_data(50, 3, **kw))
    ds = jfusion.generate_synthetic_data(140, 0)
    x = train_fusion_rf.softmax_features(*ds[3:6])
    _same(x, jrf.softmax_features(*ds[3:6]))
    from sklearn.ensemble import RandomForestClassifier
    rf = RandomForestClassifier(n_estimators=3, max_depth=5,
                                random_state=0).fit(x, ds[6])
    _same(forest.from_sklearn(rf), jforest.from_sklearn(rf))


def test_speech_loader_matches_jax(tmp_path):
    corpora.make_speech_corpus(str(tmp_path), per_class=1)
    os.makedirs(tmp_path / 'notanemotion')
    (tmp_path / 'notanemotion' / 'x.wav').write_bytes(
        (tmp_path / 'happy' / '0.wav').read_bytes())
    X, y = data.load_speech_dataset(str(tmp_path), chunk=4, verbose=False,
                                    device='cpu')
    X_ref, y_ref = jdata.load_speech_dataset(str(tmp_path), chunk=4,
                                             verbose=False)
    _same(y, y_ref)
    assert X.dtype == np.float32 and X.shape == (7, 56)
    np.testing.assert_allclose(X, X_ref, rtol=2e-6, atol=1e-4)
