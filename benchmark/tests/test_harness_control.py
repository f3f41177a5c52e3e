"""The control, kept as a test at a size a test run holds: the reference
one step below the stated precision, put in the program's place, fails
at least one of the cell's compared numbers, while the float32 reference
judged against itself reads nothing."""

import os
import subprocess
import sys

import pytest

from benchmark.tests.tiny import REPO, make_root


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp('bench')))


@pytest.mark.parametrize('cell', ['tiny_resnet50_bert_attn.one_client',
                                  'tiny_mobilenetv2_bert_rf.saturated'])
def test_control_fails_the_check(root, cell):
    import json
    code = ('import sys; sys.path[:0] = [%r, %r]\n'
            'from benchmark import control\n'
            'sys.exit(control.main(["--workload", %r, "--seeds", "21,22"],'
            ' device="cpu"))' % (root, REPO, cell))
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, cwd=root, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert p.returncode == 0, p.stderr[-3000:]
    for line in p.stdout.strip().splitlines():
        r = json.loads(line)
        assert any(r['control'][k] > lim for k, lim in r['limits'].items()), r
