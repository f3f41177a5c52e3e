"""Kaggle dataset downloader.

`python -m mec_tpu_torch download
[--dataset praveengovi/emotions-dataset-for-nlp]`

A copy of mec_tpu/datasets/download.py. Parity with reference
download_dataset.py:44-166: checks for the kaggle CLI and
~/.kaggle/kaggle.json credentials with actionable instructions,
downloads + unzips into datasets/text, then points at the organizer.
It runs only the kaggle CLI the user installs; without it, or without
credentials, it prints the setup instructions and returns False.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

DEFAULT_DATASET = 'praveengovi/emotions-dataset-for-nlp'


def kaggle_available() -> bool:
    return shutil.which('kaggle') is not None


def credentials_present() -> bool:
    return (Path.home() / '.kaggle' / 'kaggle.json').exists() or \
        ('KAGGLE_USERNAME' in os.environ and 'KAGGLE_KEY' in os.environ)


def print_setup_instructions() -> None:
    print("""
Kaggle setup required:
  1. pip install kaggle
  2. Create an API token at https://www.kaggle.com/settings ->
     'Create New Token' (downloads kaggle.json)
  3. mkdir -p ~/.kaggle && mv ~/Downloads/kaggle.json ~/.kaggle/
     chmod 600 ~/.kaggle/kaggle.json
Then re-run this command.
""")


def download_dataset(dataset: str = DEFAULT_DATASET,
                     dest: str = 'datasets/text') -> bool:
    if not kaggle_available():
        print('kaggle CLI not found.')
        print_setup_instructions()
        return False
    if not credentials_present():
        print('Kaggle credentials not found.')
        print_setup_instructions()
        return False

    dest_path = Path(dest)
    dest_path.mkdir(parents=True, exist_ok=True)
    print(f'Downloading {dataset} -> {dest_path} ...')
    try:
        subprocess.run(['kaggle', 'datasets', 'download', '-d', dataset,
                        '-p', str(dest_path)], check=True)
    except subprocess.CalledProcessError as e:
        print(f'Download failed: {e}')
        return False

    for zpath in dest_path.glob('*.zip'):
        print(f'Unzipping {zpath.name} ...')
        with zipfile.ZipFile(zpath) as z:
            z.extractall(dest_path)
        zpath.unlink()
    print('Done. Now run: python -m mec_tpu_torch organize text')
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description='Download a Kaggle dataset')
    p.add_argument('--dataset', default=DEFAULT_DATASET)
    p.add_argument('--dest', default='datasets/text')
    args = p.parse_args(argv)
    ok = download_dataset(args.dataset, args.dest)
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
