"""mec_tpu_torch.datasets (download, organize) against mec_tpu.datasets.

Seeded raw trees (TESS speech folders with a nested duplicate level and
pleasant-surprise names, FER2013 train/test splits with an unknown
emotion and a stray file, Emotions-NLP 'text;label' files with mapped,
unknown and malformed lines) are organized by both packages in two
copies; the resulting file trees must be equal file for file and byte
for byte, the CSV included. `download` is held to JAX without the kaggle
CLI, without credentials, and with a stub `kaggle` script on PATH that
writes a zip into its -p directory. Nothing here reaches the network.
"""

import os
import shutil
import sys

import numpy as np
import pytest

from mec_tpu.datasets import download as jdownload
from mec_tpu.datasets import organize as jorganize
from mec_tpu_torch.datasets import download, organize

TESS = 'TESS Toronto emotional speech set data'


def _blob(rng, n=64):
    return bytes(rng.randint(0, 256, n, dtype=np.uint8))


def _raw_tree(base):
    """The three raw downloads the organizer reads, from a seed."""
    rng = np.random.RandomState(0)
    tess = base / TESS
    folders = ['OAF_angry', 'YAF_pleasant_surprised', 'OAF_Pleasant_surprise',
               'YAF_sad', 'OAF_neutral', 'not_an_emotion']
    for name in folders:
        (tess / name).mkdir(parents=True)
        for i in range(3):
            (tess / name / f'{name}_w{i}.wav').write_bytes(_blob(rng))
    nested = tess / TESS / 'YAF_fear'
    nested.mkdir(parents=True)
    for i in range(2):
        (nested / f'YAF_fear_w{i}.wav').write_bytes(_blob(rng))
    (tess / 'readme.txt').write_text('not a folder')
    fer = base / 'FER2013'
    for split in ('train', 'test'):
        for emotion in ('happy', 'sad', 'surprise', 'contempt'):
            d = fer / split / emotion
            d.mkdir(parents=True)
            for i, ext in enumerate(('.jpg', '.png', '.JPEG', '.txt')):
                (d / f'{i}{ext}').write_bytes(_blob(rng))
    nlp = base / 'emotion_dataset'
    nlp.mkdir()
    labels = ['joy', 'love', 'sadness', 'anger', 'fear', 'surprise',
              'boredom', 'Neutral']
    for name in ('train.txt', 'test.txt', 'val.txt'):
        lines = [f'sentence {name} {i}; part two;'
                 f'{labels[rng.randint(len(labels))]}' for i in range(20)]
        lines += ['', 'no separator here', '  padded text ;  JOY  ']
        (nlp / name).write_text('\n'.join(lines) + '\n', encoding='utf-8')


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, 'rb') as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _dirs(root):
    return sorted(os.path.relpath(d, root) for d, _s, _n in os.walk(root))


@pytest.mark.parametrize('what', ['speech', 'images', 'text', 'all'])
def test_organize_matches_jax(tmp_path, what):
    _raw_tree(tmp_path / 'raw')
    ref, got = tmp_path / 'jax', tmp_path / 'port'
    shutil.copytree(tmp_path / 'raw', ref)
    shutil.copytree(tmp_path / 'raw', got)
    jorganize.main([what, '--base', str(ref)])
    organize.main([what, '--base', str(got)])
    assert organize.EMOTIONS == jorganize.EMOTIONS
    assert _dirs(got) == _dirs(ref)
    files = _files(got)
    assert files == _files(ref)
    if what in ('text', 'all'):
        csv = files[os.path.join('text', 'emotion_dataset.csv')]
        assert csv.startswith(b'text,label\r\n') and b'boredom' not in csv
    if what in ('speech', 'all'):
        assert os.path.join('speech', 'surprise',
                            'YAF_pleasant_surprised_YAF_pleasant_surprised_w0'
                            '.wav') in files
        assert os.path.join('speech', 'fear',
                            'YAF_fear_YAF_fear_w1.wav') in files


def _stub_kaggle(bin_dir):
    """A `kaggle` executable that writes a seeded zip into its -p dir."""
    bin_dir.mkdir()
    script = bin_dir / 'kaggle'
    script.write_text(
        f'#!{sys.executable}\n'
        'import os, sys, zipfile\n'
        'dest = sys.argv[sys.argv.index("-p") + 1]\n'
        'with zipfile.ZipFile(os.path.join(dest, "emotions.zip"), "w") as z:\n'
        '    for name in ("train.txt", "test.txt", "val.txt"):\n'
        '        z.writestr(name, "".join(f"text {name} {i};joy\\n"\n'
        '                                 for i in range(5)))\n'
        '    z.writestr("nested/readme.md", "seeded")\n')
    script.chmod(0o755)


@pytest.mark.parametrize('case', ['no_cli', 'no_credentials', 'stub_cli'])
def test_download_matches_jax(tmp_path, monkeypatch, capsys, case):
    home = tmp_path / 'home'
    home.mkdir()
    monkeypatch.setenv('HOME', str(home))
    monkeypatch.delenv('KAGGLE_USERNAME', raising=False)
    monkeypatch.delenv('KAGGLE_KEY', raising=False)
    bin_dir = tmp_path / 'bin'
    if case == 'no_cli':
        bin_dir.mkdir()
        monkeypatch.setenv('PATH', str(bin_dir))
    else:
        _stub_kaggle(bin_dir)
        monkeypatch.setenv('PATH', f'{bin_dir}{os.pathsep}'
                           f'{os.environ.get("PATH", "")}')
    if case == 'stub_cli':
        monkeypatch.setenv('KAGGLE_USERNAME', 'user')
        monkeypatch.setenv('KAGGLE_KEY', 'key')
    ok_ref = jdownload.download_dataset(dest=str(tmp_path / 'jax'))
    said_ref = capsys.readouterr().out
    ok = download.download_dataset(dest=str(tmp_path / 'port'))
    said = capsys.readouterr().out
    assert ok == ok_ref == (case == 'stub_cli')
    if case == 'stub_cli':
        files = _files(tmp_path / 'port')
        assert files == _files(tmp_path / 'jax')
        assert sorted(files) == ['nested/readme.md', 'test.txt',
                                 'train.txt', 'val.txt']
        assert 'python -m mec_tpu_torch organize text' in said
    else:
        assert said == said_ref
        assert not (tmp_path / 'port').exists()
    with pytest.raises(SystemExit) as done:
        download.main(['--dest', str(tmp_path / 'cli')])
    assert done.value.code == (0 if case == 'stub_cli' else 1)

