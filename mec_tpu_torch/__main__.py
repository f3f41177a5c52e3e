"""Command-line front door: ``python -m mec_tpu_torch <command> [args...]``.

The port of mec_tpu/__main__.py's dispatcher, with its six train
commands, serve and convert; each trainer module has main(argv) taking
the JAX trainer's flags plus --device (default cuda), as does serve
(webapp/serve.py). Dispatch is lazy: only the selected
command's module is imported. A train command with --mesh-data N > 1
(train-text-bert: --mesh-data D, --mesh-model M, --mesh-pipe P, any
above 1) runs in N = D*M*P ranks, one process a device
(parallel/launch.py: cuda:0 .. cuda:N-1, or N CPU ranks over gloo with
--device cpu; fewer visible GPUs than N raises), unless this process is
already one rank of a group (torchrun's or the MEC_* variables,
parallel/distributed.py), in which case it initializes that group and
runs its own rank. download and organize are the dataset tools
(datasets/), as in the JAX package.
"""

from __future__ import annotations

import importlib
import math
import sys
from typing import List, Optional

# command -> (module with main(argv), one-line help)
_COMMANDS = {
    'train-speech': ('mec_tpu_torch.training.train_speech',
                     'train the 5-block speech DNN on a wav tree'),
    'train-text-bert': ('mec_tpu_torch.training.train_text_bert',
                        'fine-tune BERT on a labeled text CSV'),
    'train-text-lstm': ('mec_tpu_torch.training.train_text_lstm',
                        'train the Bi-LSTM text variant'),
    'train-image': ('mec_tpu_torch.training.train_image',
                    'train ResNet50 / MobileNetV2 on an image tree'),
    'train-fusion': ('mec_tpu_torch.training.train_fusion',
                     'train the attention fusion net (synthetic or '
                     '--manifest real triples)'),
    'train-fusion-rf': ('mec_tpu_torch.training.train_fusion_rf',
                        'train the random-forest fusion variant (sklearn)'),
    'serve': ('mec_tpu_torch.webapp.serve',
              'run the web service (werkzeug; --device cuda by default)'),
    'convert': ('mec_tpu_torch.convert.__main__',
                'convert reference checkpoints (.h5/.pt/.pkl/HF) to .mecp'),
    'download': ('mec_tpu_torch.datasets.download',
                 'download the Emotions-NLP dataset via Kaggle'),
    'organize': ('mec_tpu_torch.datasets.organize',
                 'reorganize TESS / FER2013 / Emotions-NLP layouts'),
}


def _usage() -> str:
    width = max(len(name) for name in _COMMANDS)
    lines = [f'  {name:<{width}}  {help_}'
             for name, (_mod, help_) in _COMMANDS.items()]
    return ('usage: python -m mec_tpu_torch <command> [args...]\n\n'
            'commands:\n' + '\n'.join(lines) +
            "\n\nRun 'python -m mec_tpu_torch <command> --help' for that "
            "command's arguments.")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(_usage(), file=sys.stderr)
        return 2
    if argv[0] in ('-h', '--help', 'help'):
        print(_usage())
        return 0
    if argv[0] == '--version':
        from mec_tpu_torch import __version__
        print(__version__)
        return 0
    cmd = argv[0]
    entry = _COMMANDS.get(cmd)
    if entry is None:
        close = [n for n in _COMMANDS if n.startswith(cmd.split('-')[0])]
        hint = f" (did you mean: {', '.join(close)}?)" if close else ''
        print(f'mec_tpu_torch: unknown command {cmd!r}{hint}\n\n' + _usage(),
              file=sys.stderr)
        return 2
    axes = [(f, int(_flag_value(argv[1:], f) or 0))
            for f in ('--mesh-data', '--mesh-model', '--mesh-pipe')]
    n = math.prod(max(1, v) for _f, v in axes)
    if n > 1:
        from mec_tpu_torch.parallel import distributed, launch
        if not distributed.initialize_multi_host():
            device = _flag_value(argv[1:], '--device') or 'cuda'
            what = ' '.join(f'{f} {v}' for f, v in axes if v > 1)
            launch.launch(launch.run_module_main, n,
                          args=(entry[0], argv[1:]),
                          devices=launch.devices_for(n, device, what))
            return 0
    mod = importlib.import_module(entry[0])
    rc = mod.main(argv[1:])
    return 0 if rc is None else int(rc)


def _flag_value(argv: List[str], flag: str) -> Optional[str]:
    """The value of `flag` in argv (`--flag V` or `--flag=V`), or None."""
    for i, a in enumerate(argv):
        if a == flag and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(flag + '='):
            return a.split('=', 1)[1]
    return None


if __name__ == '__main__':
    sys.exit(main())
