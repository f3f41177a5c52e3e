"""Dataset loading for the trainers: the port of mec_tpu/training/data.py.

The speech loader extracts the 56 features on the device in chunks of
`chunk` clips through the fp32 parity frontend,
ops/audio_features.audio_features_56(y, 'parity') (the JAX loader's
audio_features_56_jit, audio_features.py:744-748): on the card it
launches K2 tuning_select once a chunk, and K1, K3 and K4 never. The
text loaders, the image listing and loading and the augmentation are
numpy copies of the JAX package's, pinned bit for bit by
tests/test_torch_train_data.py.

Text loaders mirror the reference's tolerant CSV parsing
(reference model_training/train_text_model.py:144-159 and
train_lstm_text_model.py:35-93) without pandas: ';'/','/tab separators,
string or numeric labels, joy->happy / love->happy style folding.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import wav

# RAVDESS filename emotion codes ('03-01-05-...' → angry etc.); the
# reference maps via substring search in the filename
# (train_speech_model.py --label-from name).
RAVDESS_CODE_MAP = {
    '-01-': 'neutral', '-02-': 'neutral', '-03-': 'happy', '-04-': 'sad',
    '-05-': 'angry', '-06-': 'fear', '-07-': 'disgust', '-08-': 'surprise',
}

# Extra label folding used by the reference text pipeline
# (reference organize_datasets.py:155-232, train_lstm_text_model.py:69-84).
TEXT_LABEL_FOLD = {
    'joy': 'happy', 'love': 'happy', 'happiness': 'happy',
    'sadness': 'sad', 'anger': 'angry', 'fearful': 'fear',
    'scared': 'fear', 'surprised': 'surprise', 'disgusted': 'disgust',
    'calm': 'neutral',
}


def _label_from_path(fp: str, label_from: str,
                     name_map: Optional[Dict[str, str]]) -> Optional[str]:
    if label_from == 'parent':
        return os.path.basename(os.path.dirname(fp)).lower()
    base = os.path.basename(fp).lower()
    mapping = name_map or RAVDESS_CODE_MAP
    for key, val in mapping.items():
        if key.lower() in base:
            return val
    return None


def load_speech_dataset(data_root: str, pattern: str = '**/*.wav',
                        label_from: str = 'parent',
                        name_map: Optional[Dict[str, str]] = None,
                        chunk: int = 256, verbose: bool = True,
                        device='cuda') -> Tuple[np.ndarray, np.ndarray]:
    """Glob wavs → (features float32[N,56], labels int[N]).

    Decoding is CPU (stdlib WAV reader); feature extraction runs on
    `device` in chunks of `chunk` clips through the parity frontend.
    """
    files = sorted(glob.glob(os.path.join(data_root, pattern),
                             recursive=True))
    if verbose:
        print(f'Found {len(files)} audio files')
    label_to_idx = {e: i for i, e in enumerate(Config.EMOTIONS)}

    waves: List[np.ndarray] = []
    labels: List[int] = []
    feats_out: List[np.ndarray] = []

    def flush():
        if not waves:
            return
        batch = torch.from_numpy(np.stack(waves, axis=0)).to(device)
        with torch.no_grad():
            feats_out.append(af.audio_features_56(batch, 'parity').cpu()
                             .numpy())
        waves.clear()

    for i, fp in enumerate(files):
        if verbose and i % 200 == 0:
            print(f'  decoding {i}/{len(files)}...', end='\r')
        lbl = _label_from_path(fp, label_from, name_map)
        if lbl not in label_to_idx:
            continue
        try:
            y, _sr = wav.load_and_fix_length(fp, sr=Config.SAMPLE_RATE,
                                             duration=Config.AUDIO_DURATION)
        except Exception as e:
            if verbose:
                print(f'\nSkip {fp}: {e}')
            continue
        waves.append(y.astype(np.float32))
        labels.append(label_to_idx[lbl])
        if len(waves) >= chunk:
            flush()
    flush()
    if verbose:
        print(f'\nProcessed {len(labels)} files')

    X = (np.concatenate(feats_out, axis=0) if feats_out
         else np.zeros((0, 56), np.float32))
    y = np.array(labels, dtype=np.int32)
    if verbose:
        print('Class distribution:')
        for e, i in label_to_idx.items():
            print(f'  {e}: {int((y == i).sum())} samples')
    return X, y


def _sniff_rows(path: str) -> List[List[str]]:
    """Parse a text dataset file trying ';', ',', then tab separators."""
    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        sample = f.read()
    for sep in (';', ',', '\t'):
        rows = [r for r in csv.reader(sample.splitlines(), delimiter=sep)
                if r]
        if rows and sum(1 for r in rows if len(r) >= 2) > len(rows) * 0.5:
            return [r[:2] if len(r) > 2 else r for r in
                    ([c.strip() for c in row] for row in rows)]
    return [[line.strip()] for line in sample.splitlines() if line.strip()]


def load_text_dataset(path: str, fold_labels: bool = True,
                      verbose: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """CSV/TXT → (texts, emotion label indices), reference-tolerant.

    Handles header/no-header, string emotion labels (with substring
    matching against Config.EMOTIONS and joy/love folding) and numeric
    labels (index into Config.EMOTIONS).
    """
    rows = _sniff_rows(path)
    if rows and rows[0] and rows[0][0].lower() in ('text', 'sentence'):
        rows = rows[1:]
    label_to_idx = {e: i for i, e in enumerate(Config.EMOTIONS)}
    texts: List[str] = []
    labels: List[int] = []
    dropped: Dict[str, int] = {}
    for row in rows:
        if len(row) < 2:
            continue
        text, raw = row[0], row[1].strip().lower()
        emotion: Optional[str] = None
        if raw.lstrip('-').isdigit():
            k = int(raw)
            if 0 <= k < len(Config.EMOTIONS):
                emotion = Config.EMOTIONS[k]
        else:
            if fold_labels and raw in TEXT_LABEL_FOLD:
                raw = TEXT_LABEL_FOLD[raw]
            for e in Config.EMOTIONS:
                if e in raw or raw in e:
                    emotion = e
                    break
        if emotion is None:
            dropped[raw] = dropped.get(raw, 0) + 1
            continue
        texts.append(text.lower().strip())
        labels.append(label_to_idx[emotion])
    if dropped:
        # the reference's exact-label filter drops these too (reference
        # train_text_model.py:151-152) but prints the class distribution;
        # silent data loss on dair-ai-style labels (anger/joy/love) has
        # bitten people, so always say what was discarded
        total = sum(dropped.values())
        detail = ', '.join(f'{k!r}: {v}' for k, v in
                           sorted(dropped.items(), key=lambda kv: -kv[1])[:8])
        print(f'WARNING: dropped {total} rows with unmapped labels '
              f'({detail}). With fold_labels=True, joy/love fold to '
              f'happy (TEXT_LABEL_FOLD).')
    if verbose:
        y = np.array(labels)
        print(f'Loaded {len(texts)} text samples from {path}')
        for e, i in label_to_idx.items():
            n = int((y == i).sum()) if len(y) else 0
            if n:
                print(f'  {e}: {n}')
    return np.array(texts, dtype=object), np.array(labels, dtype=np.int32)


def list_image_dataset(data_root: str, verbose: bool = True
                       ) -> Tuple[List[str], np.ndarray]:
    """ImageFolder-style listing: data_root/<emotion>/*.{jpg,png} →
    (paths, labels). (reference train_image_model.py uses torchvision
    ImageFolder, :135-148.)"""
    label_to_idx = {e: i for i, e in enumerate(Config.EMOTIONS)}
    paths: List[str] = []
    labels: List[int] = []
    for cls in sorted(os.listdir(data_root)):
        cls_dir = os.path.join(data_root, cls)
        if not os.path.isdir(cls_dir) or cls.lower() not in label_to_idx:
            continue
        for fn in sorted(os.listdir(cls_dir)):
            if fn.lower().endswith(('.jpg', '.jpeg', '.png', '.bmp')):
                paths.append(os.path.join(cls_dir, fn))
                labels.append(label_to_idx[cls.lower()])
    if verbose:
        print(f'Found {len(paths)} images in {data_root}')
    return paths, np.array(labels, dtype=np.int32)


def load_images_uint8(paths: Sequence[str], size: int = 224,
                      verbose: bool = True) -> np.ndarray:
    from mec_tpu_torch.image.preprocess import load_image_uint8
    out = np.zeros((len(paths), size, size, 3), np.uint8)
    for i, p in enumerate(paths):
        if verbose and i % 500 == 0:
            print(f'  loading image {i}/{len(paths)}...', end='\r')
        out[i] = load_image_uint8(p, (size, size))
    if verbose:
        print()
    return out


def augment_images_uint8(imgs: np.ndarray, rng: np.random.RandomState
                         ) -> np.ndarray:
    """Random horizontal flip, ±15° rotation, brightness/contrast jitter —
    the reference's torchvision augmentations
    (reference train_image_model.py:135-148), as one vectorized numpy pass.
    """
    n, h, w, _ = imgs.shape
    out = imgs.copy()
    # horizontal flip, p=0.5
    flip = rng.rand(n) < 0.5
    out[flip] = out[flip, :, ::-1]
    # rotation ±15° via nearest-neighbor grid sample (cheap, label-safe)
    angles = rng.uniform(-15, 15, size=n) * np.pi / 180.0
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    for i in range(n):
        a = angles[i]
        if abs(a) < 1e-3:
            continue
        ys = cy + (yy - cy) * np.cos(a) - (xx - cx) * np.sin(a)
        xs = cx + (yy - cy) * np.sin(a) + (xx - cx) * np.cos(a)
        ysi = np.clip(np.rint(ys).astype(np.int32), 0, h - 1)
        xsi = np.clip(np.rint(xs).astype(np.int32), 0, w - 1)
        out[i] = out[i, ysi, xsi]
    # brightness/contrast jitter (torchvision ColorJitter 0.2/0.2)
    b = rng.uniform(0.8, 1.2, size=(n, 1, 1, 1))
    c = rng.uniform(0.8, 1.2, size=(n, 1, 1, 1))
    x = out.astype(np.float32) * b
    mean = x.mean(axis=(1, 2, 3), keepdims=True)
    x = (x - mean) * c + mean
    return np.clip(x, 0, 255).astype(np.uint8)
