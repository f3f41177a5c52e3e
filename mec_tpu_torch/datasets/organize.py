"""Reorganize raw downloads into the training layout.

`python -m mec_tpu_torch organize [--base datasets] [speech|images|text|all]`

A copy of mec_tpu/datasets/organize.py. Behavioral parity with reference
organize_datasets.py:
  * TESS (reference :20-102): 'OAF_angry'-style folders -> datasets/speech/
    <emotion>/<prefix>_<file>.wav, with pleasant_surprise(-d) -> surprise
    and one level of nesting tolerated.
  * FER2013 (reference :105-152): train/ and test/ emotion folders merged
    into datasets/images/<emotion>/ with a split prefix on filenames.
  * Emotions-NLP (reference :155-232): train/test/val .txt ('text;label')
    folded into one datasets/text/emotion_dataset.csv with joy/love ->
    happy etc.
"""

from __future__ import annotations

import argparse
import csv
import shutil
from pathlib import Path
from typing import Dict, List

from mec_tpu_torch.config import Config

EMOTIONS = list(Config.EMOTIONS)

TESS_EMOTION_MAP: Dict[str, str] = {
    'angry': 'angry', 'disgust': 'disgust', 'fear': 'fear',
    'happy': 'happy', 'neutral': 'neutral', 'sad': 'sad',
    'pleasant_surprise': 'surprise', 'pleasant_surprised': 'surprise',
    'surprise': 'surprise',
}

TEXT_LABEL_MAP: Dict[str, str] = {
    'joy': 'happy', 'happiness': 'happy', 'happy': 'happy',
    'love': 'happy', 'sadness': 'sad', 'sad': 'sad', 'anger': 'angry',
    'angry': 'angry', 'fear': 'fear', 'surprise': 'surprise',
    'disgust': 'disgust', 'neutral': 'neutral',
}


def _tess_emotion_of(folder_name: str) -> str | None:
    name = folder_name.lower()
    # longest-match so 'pleasant_surprise' wins over 'surprise'
    for key in sorted(TESS_EMOTION_MAP, key=len, reverse=True):
        if key in name:
            return TESS_EMOTION_MAP[key]
    return None


def organize_speech_tess(base: Path, tess_dirname: str =
                         'TESS Toronto emotional speech set data') -> int:
    """TESS -> datasets/speech/<emotion>/*.wav. Returns files organized."""
    tess_root = base / tess_dirname
    speech_dir = base / 'speech'
    if not tess_root.exists():
        print(f'TESS folder not found at {tess_root}')
        return 0
    for e in EMOTIONS:
        (speech_dir / e).mkdir(parents=True, exist_ok=True)

    count = 0

    def process(folder: Path) -> None:
        nonlocal count
        emotion = _tess_emotion_of(folder.name)
        if emotion is None:
            return
        for wav in folder.glob('*.wav'):
            target = speech_dir / emotion / f'{folder.name}_{wav.name}'
            if not target.exists():
                shutil.copy2(wav, target)
                count += 1

    for folder in sorted(tess_root.iterdir()):
        if not folder.is_dir():
            continue
        if folder.name == tess_dirname:  # nested duplicate level
            for nested in sorted(folder.iterdir()):
                if nested.is_dir():
                    process(nested)
        else:
            process(folder)

    for e in EMOTIONS:
        print(f'  {e}: {len(list((speech_dir / e).glob("*.wav")))} files')
    print(f'Total speech files organized: {count}')
    return count


def organize_images_fer2013(base: Path, fer_dirname: str = 'FER2013'
                            ) -> int:
    """FER2013 train+test -> datasets/images/<emotion>/<split>_<name>."""
    fer_root = base / fer_dirname
    images_dir = base / 'images'
    if not fer_root.exists():
        print(f'FER2013 folder not found at {fer_root}')
        return 0
    for e in EMOTIONS:
        (images_dir / e).mkdir(parents=True, exist_ok=True)

    count = 0
    for split in ('train', 'test'):
        split_dir = fer_root / split
        if not split_dir.exists():
            continue
        for emotion_folder in sorted(split_dir.iterdir()):
            if not emotion_folder.is_dir():
                continue
            emotion = emotion_folder.name.lower()
            if emotion not in EMOTIONS:
                print(f'  Skipping unknown emotion folder: {emotion}')
                continue
            for img in emotion_folder.glob('*'):
                if img.suffix.lower() not in ('.jpg', '.jpeg', '.png'):
                    continue
                target = images_dir / emotion / f'{split}_{img.name}'
                if not target.exists():
                    shutil.copy2(img, target)
                    count += 1
    for e in EMOTIONS:
        print(f'  {e}: {len(list((images_dir / e).glob("*")))} files')
    print(f'Total image files organized: {count}')
    return count


def organize_text_emotion(base: Path, src_dirname: str = 'emotion_dataset'
                          ) -> int:
    """train/test/val.txt ('text;label') -> datasets/text/emotion_dataset.csv."""
    src = base / src_dirname
    text_dir = base / 'text'
    text_dir.mkdir(parents=True, exist_ok=True)

    rows: List[Dict[str, str]] = []
    for txt_name in ('train.txt', 'test.txt', 'val.txt'):
        path = src / txt_name
        if not path.exists():
            continue
        print(f'  Processing {txt_name}...')
        with open(path, encoding='utf-8') as f:
            for line in f:
                line = line.strip()
                if not line or ';' not in line:
                    continue
                text, label = line.rsplit(';', 1)
                label = label.lower().strip()
                if label in TEXT_LABEL_MAP:
                    rows.append({'text': text.strip(),
                                 'label': TEXT_LABEL_MAP[label]})

    csv_path = text_dir / 'emotion_dataset.csv'
    with open(csv_path, 'w', newline='', encoding='utf-8') as f:
        writer = csv.DictWriter(f, fieldnames=['text', 'label'])
        writer.writeheader()
        writer.writerows(rows)
    counts = {e: sum(1 for r in rows if r['label'] == e) for e in EMOTIONS}
    for e, c in counts.items():
        print(f'  {e}: {c} samples')
    print(f'Total text samples: {len(rows)}\nCSV saved to: {csv_path}')
    return len(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description='Organize raw datasets')
    p.add_argument('what', nargs='?', default='all',
                   choices=['speech', 'images', 'text', 'all'])
    p.add_argument('--base', default='datasets')
    args = p.parse_args(argv)
    base = Path(args.base)
    if args.what in ('speech', 'all'):
        organize_speech_tess(base)
    if args.what in ('images', 'all'):
        organize_images_fer2013(base)
    if args.what in ('text', 'all'):
        organize_text_emotion(base)


if __name__ == '__main__':
    main()
