"""No module under benchmark/ imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: mec_tpu_torch is the port), the
reference imports nothing of the port either, and the run's own guard
tells the two apart."""

import ast
import os

import pytest

from benchmark import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.join(d, f) for d, _s, fs in os.walk(BENCH)
               for f in fs if f.endswith('.py') and '_cache' not in d)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) in (
                'import_module', '__import__') and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split('.')[0]


@pytest.mark.parametrize('path', FILES,
                         ids=[os.path.relpath(p, BENCH) for p in FILES])
def test_no_jax_anywhere(path):
    assert not set(imported(path)) & {'jax', 'jaxlib', 'flax', 'mec_tpu'}


def test_reference_imports_nothing_of_the_program():
    ref = [p for p in FILES if os.sep + 'reference' + os.sep in p]
    assert len(ref) >= 10
    for p in ref:
        assert 'mec_tpu_torch' not in set(imported(p)), p


def test_guard_compares_whole_top_level_names():
    assert run.forbidden_modules(['mec_tpu_torch', 'mec_tpu_torch.ops',
                                  'jaxtyping', 'flaxen']) == []
    assert run.forbidden_modules(['mec_tpu.ops.wav', 'jax', 'flax.linen',
                                  'jaxlib']) == ['flax', 'jax', 'jaxlib',
                                                 'mec_tpu']
