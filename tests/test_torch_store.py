"""The port's .mecp reader and writer (mec_tpu_torch/convert/store.py)
against flax's msgpack serialization (mec_tpu/convert/store.py).

Contract: the port's save_params(path, tree, meta) writes the bytes of
flax's MAGIC + msgpack_serialize({'variables': tree, 'meta': meta}),
for the six artifact trees of a models directory (here the port's numpy
trees written by flax; the JAX writer's own files are held the same way
in tests/test_torch_models_dir.py) and for metas of every type flax
writes (ints of every width, floats, numpy scalars, strings and bytes of
every length class, lists, nested dicts, int8_scales); each package
reads the other's files to equal trees (same dtypes and shapes,
np.array_equal). Exact: both sides are deterministic encoders of the
same values.
"""

import os
import warnings

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from mec_tpu.convert import store as jstore
from mec_tpu_torch.convert import store
from mec_tpu_torch.serving import synthetic_artifacts as sa

ARTIFACTS = ('speech_model.mecp', 'bert_model.mecp', 'image_model.mecp',
             'mobilenet_model.mecp', 'fusion_model.mecp', 'fusion_rf.mecp')


def _assert_same_tree(a, b, path=''):
    assert type(a) is type(b) or (isinstance(a, np.generic)
                                  and isinstance(b, np.generic)), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f'{path}/{k}')
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f'{path}[{i}]')
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def _reversed(tree):
    """The tree with every dict's keys in reverse order (the writer
    must sort them back)."""
    if isinstance(tree, dict):
        return {k: _reversed(tree[k]) for k in reversed(list(tree))}
    return tree


def _meta():
    return {
        'zeta': 1, 'arch': 'mobilenet_v2', 'img_size': 224,
        'ints': [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                 -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        'floats': [0.0, -1.5, 1e300, float('inf'), 0.1],
        'np': [np.float64(3.0), np.float32(2.5), np.int64(7), np.int8(-3),
               np.bool_(True), np.uint16(9)],
        'flags': [True, False, None],
        'strs': ['', 'x' * 31, 'y' * 32, 'z' * 255, 'w' * 256,
                 'v' * 70000, 'émotion'],
        'bytes': [b'', b'\x00' * 300, b'\x01' * 70000],
        'nested': {'b': {'c': np.arange(5, dtype=np.int16)},
                   'a': np.zeros((0, 3), np.float32)},
        'long': list(range(20)), 'wide': {f'k{i:02d}': i for i in range(20)},
        'int8_scales': {'image|resnet50|32x32|bfloat16|m1.25|v1': {
            'layer1_0/conv1': 0.0123, 'layer1_0/conv2': 0.25}},
        'val_acc': 0.9}


@pytest.fixture(scope='module')
def jax_dir(tmp_path_factory):
    """The six trees, written by the JAX package's store (flax)."""
    d = str(tmp_path_factory.mktemp('jax_artifacts'))
    image, image_meta = sa.image_variables(1, 32)
    mobile, mobile_meta = sa.mobilenet_variables(2, 32)
    forest, forest_meta = sa.forest_arrays(3, n_trees=4, depth=5)
    trees = {'speech_model.mecp': (sa.speech_variables(0), {}),
             'bert_model.mecp': (sa.bert_variables(
                 0, vocab_size=120, hidden_size=32, num_layers=2,
                 intermediate_size=64, max_position=64), {}),
             'image_model.mecp': (image, image_meta),
             'mobilenet_model.mecp': (mobile, mobile_meta),
             'fusion_model.mecp': (sa.fusion_variables(0, text_dim=32),
                                   {'config': {'text_dim': 32}}),
             'fusion_rf.mecp': ({'forest': forest}, forest_meta)}
    for name, (tree, meta) in trees.items():
        jstore.save_params(os.path.join(d, name), tree, meta=meta)
    return d


@pytest.mark.parametrize('name', ARTIFACTS)
def test_writer_gives_flax_bytes_for_jax_artifacts(jax_dir, name, tmp_path):
    path = os.path.join(jax_dir, name)
    with open(path, 'rb') as f:
        want = f.read()
    loaded = store.load_params(path)
    out = str(tmp_path / 'port.mecp')
    store.save_params(out, _reversed(loaded['variables']),
                      meta=_reversed(loaded['meta']))
    with open(out, 'rb') as f:
        assert f.read() == want
    _assert_same_tree(loaded, jstore.load_params(path))


def test_writer_gives_flax_bytes_for_every_meta_type(tmp_path):
    rng = np.random.RandomState(0)
    tree = {'params': {
        'w': rng.randn(3, 4).astype(np.float32),
        'transposed': rng.randn(4, 3).T,           # not C-contiguous
        'b': np.arange(3), 'h': np.ones(2, np.float16),
        'u': np.array([1, 2], np.uint32), 'mask': np.array([True, False]),
        'q': rng.randint(-127, 128, (2, 5)).astype(np.int8),
        'act_scale': np.float32(0.02), 'scalar': 1.5, 'none': None}}
    a, b = str(tmp_path / 'jax.mecp'), str(tmp_path / 'port.mecp')
    jstore.save_params(a, tree, meta=_meta())
    store.save_params(b, _reversed(tree), meta=_reversed(_meta()))
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        assert fa.read() == fb.read()
    _assert_same_tree(store.load_params(a), jstore.load_params(a))
    got = store.load_params(b)
    assert isinstance(got['meta']['np'][0], np.float64)
    assert type(got['meta']['floats'][4]) is float
    assert got['meta']['bytes'][1] == b'\x00' * 300


def _random_value(rng, depth=0):
    """A random meta value: the leaf types flax writes (ints at the edges
    of every width, floats, short and long strings, bytes, numpy
    scalars) in lists and dicts up to three deep, of up to 18 entries
    (past the fix-size headers)."""
    kind = rng.randint(9 if depth < 3 else 7)
    if kind == 0:
        edge = 2 ** int(rng.choice([4, 5, 7, 8, 15, 16, 31, 32]))
        ints = [edge - 1, edge, -edge, -edge - 1, 2 ** 63, 2 ** 64 - 1,
                -2 ** 63]
        return ints[rng.randint(len(ints))]
    if kind == 1:
        return float(rng.randn() * 10.0 ** rng.randint(-30, 30))
    if kind == 2:
        return ''.join(rng.choice(list('abcé€ 9_|'), rng.randint(0, 300)))
    if kind == 3:
        return rng.bytes(int(rng.choice([0, 5, 255, 256, 300])))
    if kind == 4:
        return [None, True, False][rng.randint(3)]
    if kind == 5:
        return rng.randn(1).astype(rng.choice(['float32', 'float64']))[0]
    if kind == 6:
        return np.int64(rng.randint(-1000, 1000))
    n = rng.randint(0, 19)
    if kind == 7:
        return [_random_value(rng, depth + 1) for _ in range(n)]
    return {f'k{rng.randint(100)}': _random_value(rng, depth + 1)
            for _ in range(n)}


@pytest.mark.parametrize('seed', range(4))
def test_writer_matches_flax_on_random_metas(seed):
    rng = np.random.RandomState(seed)
    for _ in range(15):
        meta = {f'm{i}': _random_value(rng) for i in range(rng.randint(20))}
        want = serialization.msgpack_serialize({'meta': meta})
        assert store.msgpack_serialize({'meta': meta}) == want
        _assert_same_tree(store.msgpack_restore(want),
                          serialization.msgpack_restore(want))


def test_tuple_and_huge_ints_raise_as_in_flax():
    for serialize in (serialization.msgpack_serialize,
                      store.msgpack_serialize):
        with pytest.raises(TypeError, match='tuple'):
            serialize({'meta': {'shape': (1, 2)}})
        for n in (2 ** 64, -2 ** 63 - 1):
            with pytest.raises(OverflowError):
                serialize({'meta': n})


def test_chunked_arrays_match_flax(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes travel as chunk dicts (flax's
    __msgpack_chunked_array__); at a 40-byte limit both encoders chunk
    the same arrays and the reader reassembles them."""
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 40)
    monkeypatch.setattr(store, 'MAX_CHUNK_SIZE', 40)
    tree = {'a': np.arange(50, dtype=np.float32),
            'b': {'c': np.arange(30, dtype=np.int64).reshape(5, 6)},
            'd': np.arange(3, dtype=np.float32)}
    want = serialization.msgpack_serialize(tree)
    assert store.msgpack_serialize(tree) == want
    _assert_same_tree(store.msgpack_restore(want), tree)


@pytest.mark.parametrize('n', [1, 2, 4, 8, 16, 3, 300, 70000])
def test_reader_takes_every_ext_length(n):
    """fixext 1/2/4/8/16 and ext 8/16/32: an unknown code comes back as
    (code, data), as msgpack.ExtType does."""
    buf = msgpack.packb([msgpack.ExtType(5, b'x' * n), 1])
    (code, data), one = store.msgpack_restore(buf)
    assert (code, data, one) == (5, b'x' * n, 1)


def test_reader_returns_writable_arrays(jax_dir):
    tree = store.load_params(os.path.join(jax_dir, 'speech_model.mecp'))
    k = tree['variables']['params']['dense_0']['kernel']
    assert k.flags.writeable and k.flags.owndata
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        t = torch.from_numpy(k)
    t.zero_()
    again = store.load_params(os.path.join(jax_dir, 'speech_model.mecp'))
    assert np.abs(again['variables']['params']['dense_0']['kernel']).max() > 0


def test_reader_rejects_bad_files(tmp_path):
    bad = str(tmp_path / 'bad.mecp')
    with open(bad, 'wb') as f:
        f.write(b'not a params file')
    with pytest.raises(ValueError, match='not a mec_tpu params file'):
        store.load_params(bad)
    # a bfloat16 array (what flax writes for jnp.bfloat16) needs jax
    inner = msgpack.packb(((2,), 'bfloat16', b'\x00' * 4), use_bin_type=True)
    with open(bad, 'wb') as f:
        f.write(store.MAGIC + msgpack.packb({'w': msgpack.ExtType(1, inner)}))
    with pytest.raises(ValueError, match='bfloat16'):
        store.load_params(bad)
    with open(bad, 'wb') as f:
        f.write(store.MAGIC + msgpack.packb({'w': [1, 2, 3]})[:-1])
    with pytest.raises(ValueError, match='truncated'):
        store.load_params(bad)


def test_save_params_is_atomic_and_jax_reads_it(tmp_path):
    p = str(tmp_path / 'sub' / 'a.mecp')
    store.save_params(p, {'params': {'w': np.arange(4, dtype=np.float32)}},
                      meta={'k': 1})
    store.save_params(p, {'params': {'w': np.arange(8, dtype=np.float32)}},
                      meta={'k': 2})
    loaded = jstore.load_params(p)
    np.testing.assert_array_equal(loaded['variables']['params']['w'],
                                  np.arange(8, dtype=np.float32))
    assert loaded['meta'] == {'k': 2}
    assert os.listdir(tmp_path / 'sub') == ['a.mecp']
    ref = 'models/image_model.pt'
    assert store.native_path(ref) == jstore.native_path(ref) \
        == 'models/image_model.mecp'
