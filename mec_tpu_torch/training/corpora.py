"""The synthetic corpora of the end-to-end walkthrough, for the port.

Copies of make_speech_corpus, make_text_corpus, make_image_corpus and
make_bert_tokenizer of examples/end_to_end.py:39-110 (which imports
mec_tpu, and so jax), over the port's ops/wav.write_wav and
text/wordpiece.py; tests/test_torch_train_data.py pins them to the
originals bit for bit. Each corpus is learnable by construction (a tone
frequency, a keyworded sentence, a hue band per emotion), so the
trainers' accuracy gates need no download.
"""

from __future__ import annotations

import os

import numpy as np

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import wav
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer

EMOTION_TONES = {e: 180 + 90 * i for i, e in enumerate(Config.EMOTIONS)}
EMOTION_PHRASES = {
    'happy': 'what a wonderful day i feel great',
    'sad': 'terrible news i feel so down',
    'angry': 'this makes me furious and mad',
    'fear': 'i am scared and anxious about it',
    'disgust': 'that is gross and revolting',
    'surprise': 'wow i did not expect that at all',
    'neutral': 'the meeting is at three in the afternoon',
}


def make_speech_corpus(root: str, per_class: int = 12) -> str:
    """Tonal clips: each emotion gets a distinct fundamental frequency, so
    the MFCC frontend + DNN genuinely have signal to learn."""
    rng = np.random.RandomState(0)
    t = np.arange(Config.AUDIO_SAMPLES) / Config.SAMPLE_RATE
    for emotion, f0 in EMOTION_TONES.items():
        d = os.path.join(root, emotion)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            f = f0 * (1 + rng.uniform(-0.03, 0.03))
            y = (0.4 * np.sin(2 * np.pi * f * t)
                 + 0.15 * np.sin(2 * np.pi * 2 * f * t)
                 + 0.02 * rng.randn(len(t))).astype(np.float32)
            wav.write_wav(os.path.join(d, f'{i}.wav'), y,
                          Config.SAMPLE_RATE)
    return root


def make_text_corpus(per_class: int = 20):
    rng = np.random.RandomState(1)
    fillers = ['really', 'honestly', 'you know', 'well', 'today', 'again']
    texts, labels = [], []
    for idx, (emotion, phrase) in enumerate(EMOTION_PHRASES.items()):
        for _ in range(per_class):
            words = phrase.split()
            pos = rng.randint(0, len(words) + 1)
            words.insert(pos, fillers[rng.randint(len(fillers))])
            texts.append(' '.join(words))
            labels.append(idx)
    return np.array(texts, dtype=object), np.array(labels, np.int32)


# Distinct base hue per emotion: color is the learnable signature the
# way tone frequency is for the speech corpus.
EMOTION_HUES = {e: (30 * i) / 210.0 for i, e in enumerate(Config.EMOTIONS)}


def make_image_corpus(img_size: int = 96, per_class: int = 14):
    """Color-signature face placeholders: each emotion gets a hue band
    plus luminance noise, so ResNet genuinely has signal to learn."""
    import colorsys
    rng = np.random.RandomState(2)
    imgs, labels = [], []
    for idx, emotion in enumerate(Config.EMOTIONS):
        base = np.array(colorsys.hsv_to_rgb(
            EMOTION_HUES[emotion], 0.6, 0.8)) * 255.0
        for _ in range(per_class):
            img = np.tile(base, (img_size, img_size, 1))
            img += rng.randn(img_size, img_size, 3) * 25.0
            # a dark ellipse as the face placeholder
            yy, xx = np.mgrid[0:img_size, 0:img_size]
            c = img_size / 2.0
            mask = (((yy - c) / (0.38 * img_size)) ** 2
                    + ((xx - c) / (0.30 * img_size)) ** 2) < 1.0
            img[mask] *= rng.uniform(0.45, 0.7)
            imgs.append(np.clip(img, 0, 255).astype(np.uint8))
            labels.append(idx)
    return np.stack(imgs), np.array(labels, np.int32)


def make_bert_tokenizer(texts):
    """WordPiece tokenizer over the demo corpus vocabulary (the reference
    downloads bert-base-uncased's vocab; the demo stays hermetic)."""
    import string
    words = sorted({w for t in texts for w in str(t).split()})
    tokens = ['[PAD]', '[UNK]', '[CLS]', '[SEP]', '[MASK]']
    tokens += list(string.ascii_lowercase)
    tokens += ['##' + c for c in string.ascii_lowercase]
    tokens += [w for w in words if w not in tokens]
    return WordPieceTokenizer({t: i for i, t in enumerate(tokens)})


# The fusion gate of the end-to-end fixture (600 synthetic rows, 6
# epochs, batch 64, best val_acc > 0.55) holds for the JAX trainer's
# seed-42 random stream (0.648), not for the trainer: at seeds 10-29 the
# JAX trainer's best val_acc is 0.4555 +- 0.0695 and passes 0.55 at 2 of
# 20, the port's 0.4330 +- 0.0446 (the CPU sweep of
# tests/test_torch_train_gates.py run as a script). The port's trainer,
# whose streams differ, is held to the JAX trainer's distribution
# instead: these are the JAX trainer's best val_acc at FUSION_GATE_SEEDS,
# which tests/test_torch_train_gates.py re-measures on the CPU.
FUSION_GATE_SEEDS = tuple(range(10, 16))
JAX_FUSION_BEST_VAL_ACC = (0.3626, 0.4286, 0.4835, 0.3956, 0.4286, 0.4396)


def fusion_gate_floor(port_accs) -> float:
    """The least mean best val_acc over FUSION_GATE_SEEDS that the port's
    fusion trainer may show: the JAX trainer's mean less three standard
    errors of the difference of the two means."""
    jax_accs = np.asarray(JAX_FUSION_BEST_VAL_ACC)
    port_accs = np.asarray(port_accs)
    se = np.sqrt(jax_accs.var(ddof=1) / len(jax_accs)
                 + port_accs.var(ddof=1) / len(port_accs))
    return float(jax_accs.mean() - 3.0 * se)
