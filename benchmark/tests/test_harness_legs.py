"""A configuration's text and image legs, found by architecture.

1. The weight trees of both configurations, at full size on the CPU, are
   those the harness drew before the legs were split out of
   weights/trees.py: a sha256 over every leaf of each tree, pinned.
2. A new text architecture is files and entries: a leg whose leaves are
   seeded, a reference piece, a configuration and its FLOPs added to a
   copy of the benchmark, with entries in its BENCHMARK.json, make a
   tiny cell that runs and answers correctly, traced and untraced, with
   no file of the copy edited.
3. Seeded leaves repeat in any order and in any dtype, and the BERT
   reference piece holds one layer's leaves at a time.
"""

import hashlib
import json
import os
import shutil
import types
import weakref

import numpy as np
import pytest
import torch

from benchmark.harness.cells import Cell
from benchmark.reference import bert
from benchmark.reference.precision import Prec
from benchmark.tests.tiny import REPO, make_root, run_cell, write_spec
from benchmark.weights import seeded
from benchmark.weights.trees import make_trees


def _leaves(tree, path=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{path}/{k}')
    else:
        yield path, tree


def _digest(tree) -> str:
    """sha256 over every leaf: its path, dtype, shape and bytes (a
    number, string or list: its JSON)."""
    h = hashlib.sha256()
    for path, v in _leaves(tree):
        h.update(path.encode())
        if isinstance(v, np.ndarray):
            h.update(f'{v.dtype}{v.shape}'.encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(json.dumps(v).encode())
    return h.hexdigest()


# make_trees(cfg, seed, 'cpu') of the harness before the legs (the text
# tree then under 'bert'), by tree
PINNED = {
    ('resnet50_bert_attn', 0): {
        'fusion':
            '8cf493d0edbdd391a564cd9a3169edc2554eb492ae3e911762522fe982db76d3',
        'image':
            '165dc24875595ec344679a0eaf1f182c3fc7d3ff81f5037ff4b8e8f6cdb3f428',
        'image_meta':
            '201696ecaed42979fb5628b764c419b624d426d3dc5fd7320d83f8b83bd8b8da',
        'speech':
            '5f4b1efddd8f8aa6aa2c6820e5297af88b64765f58151d19ebcc92f74484a9a4',
        'text':
            '3a17e170f1f8ae72d4f311a196843a2f8c33b2f1cb7f38a5d599a1eb31f021c1',
    },
    ('resnet50_bert_attn', 1): {
        'fusion':
            '2312d84a2428fd8ae3595254af167de9969523f3e56bb5a4bee9efd6065b8bde',
        'image':
            '356601ce8742d367063abd49a4c798e747761251598c2cabe1c52c6ff70eabbb',
        'image_meta':
            '201696ecaed42979fb5628b764c419b624d426d3dc5fd7320d83f8b83bd8b8da',
        'speech':
            '5ebb558c7afffdc53138039853378e1c71fb3f8011f761197dd4a55ea3885777',
        'text':
            'c0d4aa95e1a1c6df7f92cb5a8db0a402fe971450fd4513f55876000f248edd6f',
    },
    ('mobilenetv2_bert_rf', 0): {
        'forest':
            'a9838937f1ec88f315155d76a7b74b69d80be9f2ca316839fe4cfb8a81aa1ded',
        'forest_meta':
            '2f8d2efc8f6f8135368e1a57e168a5bb17c3c1e9c21e886cf55a6c34d1f84e8c',
        'image':
            '9c0f11e9a434182adc255753d184202371bf922fa1dcb494bd018266c4c6f6f1',
        'image_meta':
            '8a574103499c6858c6eb3a42d6d332d94e9c179fc257515e2ff09829c23ca7cd',
        'speech':
            '6bda184add83c87dc9ebbff226c17a9176aa8c35912d5856b279454c92b28258',
        'text':
            '3a17e170f1f8ae72d4f311a196843a2f8c33b2f1cb7f38a5d599a1eb31f021c1',
    },
    ('mobilenetv2_bert_rf', 1): {
        'forest':
            '51deadb1dd7c8b1496ab1579fa0805e341f3e3f2ff8f4762f9848b8833dcfa83',
        'forest_meta':
            '2f8d2efc8f6f8135368e1a57e168a5bb17c3c1e9c21e886cf55a6c34d1f84e8c',
        'image':
            '33a2d728d61b763c325fa8e5b8491bcffc94952b2699253cf23f469aceb6674b',
        'image_meta':
            '8a574103499c6858c6eb3a42d6d332d94e9c179fc257515e2ff09829c23ca7cd',
        'speech':
            'a5ec50a5f0ef743d12e6c0f47845c0611a5045d03bd2c729b44c0168b2da68a2',
        'text':
            'c0d4aa95e1a1c6df7f92cb5a8db0a402fe971450fd4513f55876000f248edd6f',
    },
}


@pytest.mark.parametrize('config,seed', sorted(PINNED))
def test_trees_are_bit_identical_to_the_pinned_draw(config, seed):
    cfg = Cell(f'{config}.one_client').config
    trees = make_trees(cfg, seed, 'cpu')
    assert {k: _digest(v) for k, v in trees.items()} == PINNED[config, seed]


# ------------------------------------------------------------------ toy leg
TOY_LEG = '''"""A toy text leg: BERT's layout under another name, every leaf
seeded (drawn alone where it is used)."""

import numpy as np

from benchmark.weights import seeded

TINY = {'hidden_size': 32, 'num_hidden_layers': 2, 'num_attention_heads': 2,
        'intermediate_size': 64, 'max_position_embeddings': 128}


def plan(d, vocab_size, hidden_size, num_hidden_layers, intermediate_size,
         max_position_embeddings, type_vocab_size, num_labels, **_ignored):
    h, f = hidden_size, intermediate_size

    def dense(din, dout, std=0.02):
        return {'kernel': seeded.normal(din, dout, std=std),
                'bias': seeded.full(0.0, dout)}

    def norm(n):
        return {'scale': seeded.uniform(0.9, 1.1, n),
                'bias': seeded.full(0.0, n)}

    params = {'word_embeddings': {'embedding': seeded.normal(
                  vocab_size, h, std=0.02)},
              'position_embeddings': {'embedding': seeded.normal(
                  max_position_embeddings, h, std=0.02)},
              'token_type_embeddings': {'embedding': seeded.normal(
                  type_vocab_size, h, std=0.02)},
              'embeddings_norm': norm(h)}
    for i in range(num_hidden_layers):
        params[f'layer_{i}'] = {
            'attention_self': {n: dense(h, h)
                               for n in ('query', 'key', 'value')},
            'attention_output': dense(h, h), 'attention_norm': norm(h),
            'intermediate': dense(h, f), 'output': dense(f, h),
            'output_norm': norm(h)}
    params['pooler'] = dense(h, h, 1 / np.sqrt(h))
    params['classifier'] = dense(h, num_labels, 8 / np.sqrt(h))
    return {'params': params}


def engine_kwargs(text, tree, vocab):
    """The port's BERT takes a numpy tree: drawn whole, in float32."""
    def host(t):
        return ({k: host(v) for k, v in t.items()} if isinstance(t, dict)
                else t.cpu().numpy())
    return dict(bert_variables=host(seeded.materialize(tree)),
                bert_kwargs=dict(
                    vocab_size=text['vocab_size'],
                    hidden_size=text['hidden_size'],
                    num_layers=text['num_hidden_layers'],
                    num_heads=text['num_attention_heads'],
                    intermediate_size=text['intermediate_size'],
                    max_position=text['max_position_embeddings'],
                    type_vocab_size=text['type_vocab_size'],
                    num_classes=text['num_labels']),
                bert_vocab=vocab)
'''

TOY_REFERENCE = '''"""The toy leg's reference: BERT's forward, which draws a
seeded tree a layer at a time."""

from benchmark.reference.bert import forward  # noqa: F401
'''

TOY_FLOPS = '''from benchmark.harness import archflops as a

FIXED = (a.frontend() + a.speech_dnn() + a.resnet50(224)
         + a.attention_fusion())


def request_flops(tokens):
    return float(FIXED + a.bert(tokens, layers=2))
'''


def _toy_leg():
    mod = types.ModuleType('toy_leg')
    exec(TOY_LEG, mod.__dict__)
    return mod


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), 'rb').read()
            for d, _s, fs in os.walk(root) for f in fs
            if '__pycache__' not in d}


def test_a_new_text_architecture_is_files_and_entries(tmp_path):
    src = str(tmp_path / 'src')
    shutil.copytree(os.path.join(REPO, 'benchmark'),
                    os.path.join(src, 'benchmark'),
                    ignore=shutil.ignore_patterns('_cache', '__pycache__'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), src)
    before = _files(src)
    bench = os.path.join(src, 'benchmark')
    with open(os.path.join(bench, 'configs', 'resnet50_bert_attn.json')) as f:
        cfg = json.load(f)
    cfg.update(name='toy_attn',
               text=dict(cfg['text'], arch='toy', num_hidden_layers=2),
               reference=dict(cfg['reference'], text='toy'))
    for path, text in (('legs/text_toy.py', TOY_LEG),
                       ('reference/toy.py', TOY_REFERENCE),
                       ('flops/toy_attn.py', TOY_FLOPS),
                       ('configs/toy_attn.json', json.dumps(cfg, indent=1))):
        assert not os.path.exists(os.path.join(bench, path)), path
        with open(os.path.join(bench, path), 'w') as f:
            f.write(text)
    with open(os.path.join(src, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    cell = 'toy_attn.one_client'
    spec['configs'].append({'name': 'toy_attn', 'source': 'a test',
                            'file': 'benchmark/configs/toy_attn.json',
                            'reduced': [], 'why': 'a new text leg'})
    spec['workloads'].append({'name': cell, 'config': 'toy_attn',
                              'traffic': 'one_client', 'chips': 1,
                              'why': 'added as files'})
    for m in spec['end_to_end'] + spec['per_layer']:
        if 'resnet50_bert_attn.one_client' in m.get('workloads', []):
            m['workloads'].append(cell)
    write_spec(src, spec)
    after = _files(src)
    assert {k for k in before if after[k] != before[k]} == {'BENCHMARK.json'}

    root = make_root(str(tmp_path / 'tiny'), src)
    with open(os.path.join(root, 'benchmark', 'configs',
                           'tiny_toy_attn.json')) as f:
        tiny = json.load(f)
    assert tiny['text']['hidden_size'] == 32
    assert tiny['fusion']['text_dim'] == 32
    assert tiny['check'] == cfg['tiny_check']
    for trace in (0, 1):
        rc, res, err = run_cell(root, 'tiny_' + cell, seed=2 ** 31 + 9,
                                trace=trace)
        assert rc == 0 and res['correct'] and res['failed'] == 0, \
            err[-3000:]
        assert res['metrics'], err[-3000:]
        if not trace:
            assert set(res['metrics']) == {'setup_s', 'latency_p50_ms'}


# -------------------------------------------------------------- seeded leaves
def _bound(tree, seed=2 ** 31 + 1):
    return seeded.bind(tree, seed, 'cpu')


def test_a_seeded_leaf_repeats_in_any_order():
    t = _bound({'a': seeded.normal(3, 5, std=0.5),
                'b': {'c': seeded.uniform(-1.0, 2.0, 7)}})
    a1, c1 = t['a'](), t['b']['c']()
    c2, a2 = t['b']['c'](), t['a']()
    assert torch.equal(a1, a2) and torch.equal(c1, c2)
    u = _bound({'b': {'c': seeded.uniform(-1.0, 2.0, 7)},
                'a': seeded.normal(3, 5, std=0.5)})
    assert torch.equal(u['a'](), a1) and torch.equal(u['b']['c'](), c1)
    assert c1.min() >= -1.0 and c1.max() < 2.0
    # another path or another seed draws other numbers
    other = _bound({'x': seeded.normal(3, 5, std=0.5)})['x']()
    assert not torch.equal(other, a1)
    assert not torch.equal(_bound({'a': seeded.normal(3, 5, std=0.5)},
                                  seed=5)['a'](), a1)


def test_a_draw_in_bf16_is_the_float32_draw_cast():
    t = _bound({'n': seeded.normal(64, 32, std=0.02),
                'u': seeded.uniform(0.5, 1.5, 33), 'f': seeded.full(0.1, 4)})
    for leaf in t.values():
        assert leaf(torch.bfloat16).dtype == torch.bfloat16
        assert torch.equal(leaf(torch.bfloat16), leaf().to(torch.bfloat16))


def test_the_reference_holds_one_layer_of_leaves_at_a_time(monkeypatch):
    toy = _toy_leg()
    text = dict(Cell('resnet50_bert_attn.one_client').config['text'],
                **dict(toy.TINY, num_hidden_layers=3))
    tree = _bound({'text': toy.plan(None, **text)})['text']
    per_layer = sum(1 for _ in _leaves(tree['params']['layer_0']))
    total = sum(1 for _ in _leaves(tree))
    live, seen = [0], {'max': 0, 'drawn': 0}
    draw = seeded.Leaf.__call__

    def counted(leaf, dtype=torch.float32):
        x = draw(leaf, dtype)
        live[0] += 1
        seen['drawn'] += 1
        seen['max'] = max(seen['max'], live[0])
        weakref.finalize(x, lambda: live.__setitem__(0, live[0] - 1))
        return x
    monkeypatch.setattr(seeded.Leaf, '__call__', counted)
    ids = torch.randint(5, 1000, (3, 12))
    mask = torch.ones(3, 12, dtype=torch.int32)
    with torch.no_grad():
        probs, feat = bert.forward(tree, ids, mask, text,
                                   Prec(None, control=False))
    assert probs.shape == (3, 7) and feat.shape == (3, text['hidden_size'])
    assert per_layer == 16 and text['num_hidden_layers'] == 3
    assert seen['drawn'] == total
    assert seen['max'] == per_layer
    assert live[0] == 0
