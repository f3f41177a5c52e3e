"""The .mecp serving artifact, read and written without flax or msgpack.

A .mecp file is ``MAGIC`` followed by flax's msgpack encoding
(``flax.serialization.msgpack_serialize``) of
``{'variables': tree, 'meta': meta}``: the format of
mec_tpu/convert/store.py, which the JAX package's engine, trainers and
converters write. The card's machine has neither flax nor msgpack, so
this module carries a small msgpack encoder and decoder in pure Python
and numpy that covers what flax writes:

  nil, bool, ints (fixint through int64/uint64), float64, str and bin
  (8/16/32), arrays, maps, and ext types (fixext 1/2/4/8/16, ext
  8/16/32). ext 1 is an ndarray: an inner msgpack array (shape, dtype
  name, C-order bytes); ext 3 is a numpy scalar packed the same way;
  ext 2 a complex (real, imag). Arrays over 2**30 bytes travel as
  ``__msgpack_chunked_array__`` dicts, undone on read.

The writer gives flax's bytes exactly: every dict's keys are sorted (flax
passes the tree through jax.tree_util.tree_map), types are strict (a
tuple raises TypeError, a numpy float64 goes out as ext 3 and not as a
float), floats are float64 and ints take their smallest form.
tests/test_torch_store.py holds both directions against flax.

The reader copies every array out of the file's buffer, so the arrays
it returns are writable and own their memory: torch.from_numpy neither
warns nor aliases the file's bytes.
"""

from __future__ import annotations

import os
import struct
from collections import namedtuple
from typing import Any, Dict, List

import numpy as np

MAGIC = b'MECP\x01'

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are chunked
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# an ext type this reader does not know (msgpack.ExtType's fields)
ExtType = namedtuple('ExtType', 'code data')

# the dtypes flax writes that numpy can rebuild from their names
_DTYPES = {np.dtype(t).name: np.dtype(t) for t in (
    np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
    np.uint32, np.uint64, np.float16, np.float32, np.float64, np.complex64,
    np.complex128)}


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------

class _Packer:
    """msgpack.Packer(use_bin_type=True, strict_types=True) with flax's
    default hook, appending to a list of byte strings; the arrays' data
    goes in as memoryviews, not copies."""

    def __init__(self):
        self.parts: List[Any] = []

    def pack(self, obj) -> None:
        out = self.parts
        t = type(obj)
        if obj is None:
            out.append(b'\xc0')
        elif t is bool:
            out.append(b'\xc3' if obj else b'\xc2')
        elif t is int:
            out.append(_pack_int(obj))
        elif t is bytes:
            out.append(_bin_header(len(obj)))
            out.append(obj)
        elif t is str:
            b = obj.encode('utf-8')
            out.append(_str_header(len(b)))
            out.append(b)
        elif t is float:
            out.append(struct.pack('>Bd', 0xcb, obj))
        elif t is list:
            out.append(_container_header(len(obj), 0x90, 0xdc, 0xdd))
            for v in obj:
                self.pack(v)
        elif t is dict:
            out.append(_container_header(len(obj), 0x80, 0xde, 0xdf))
            for k, v in obj.items():
                self.pack(k)
                self.pack(v)
        elif isinstance(obj, np.ndarray):
            self._ext(EXT_NDARRAY, _ndarray_parts(obj))
        elif isinstance(obj, np.generic):
            self._ext(EXT_NPSCALAR, _ndarray_parts(np.asarray(obj)))
        elif t is complex:
            self._ext(EXT_COMPLEX, [_pack_plain([obj.real, obj.imag])])
        else:
            raise TypeError(f'can not serialize {t.__name__!r} object')

    def _ext(self, code: int, parts: List[Any]) -> None:
        n = sum(len(p) if isinstance(p, bytes) else p.nbytes for p in parts)
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if n in fixed:
            head = struct.pack('>Bb', fixed[n], code)
        elif n <= 0xff:
            head = struct.pack('>BBb', 0xc7, n, code)
        elif n <= 0xffff:
            head = struct.pack('>BHb', 0xc8, n, code)
        else:
            head = struct.pack('>BIb', 0xc9, n, code)
        self.parts.append(head)
        self.parts.extend(parts)


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack('B', n)
    if -0x20 <= n < 0:
        return struct.pack('b', n)
    if 0x80 <= n <= 0xff:
        return struct.pack('BB', 0xcc, n)
    if -0x80 <= n < 0:
        return struct.pack('>Bb', 0xd0, n)
    if 0xff < n <= 0xffff:
        return struct.pack('>BH', 0xcd, n)
    if -0x8000 <= n < -0x80:
        return struct.pack('>Bh', 0xd1, n)
    if 0xffff < n <= 0xffffffff:
        return struct.pack('>BI', 0xce, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack('>Bi', 0xd2, n)
    if 0xffffffff < n <= 0xffffffffffffffff:
        return struct.pack('>BQ', 0xcf, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack('>Bq', 0xd3, n)
    raise OverflowError('Integer value out of range')


def _bin_header(n: int) -> bytes:
    if n <= 0xff:
        return struct.pack('>BB', 0xc4, n)
    if n <= 0xffff:
        return struct.pack('>BH', 0xc5, n)
    if n <= 0xffffffff:
        return struct.pack('>BI', 0xc6, n)
    raise ValueError('bin is too large')


def _str_header(n: int) -> bytes:
    if n <= 0x1f:
        return struct.pack('B', 0xa0 | n)
    if n <= 0xff:
        return struct.pack('>BB', 0xd9, n)
    if n <= 0xffff:
        return struct.pack('>BH', 0xda, n)
    if n <= 0xffffffff:
        return struct.pack('>BI', 0xdb, n)
    raise ValueError('string is too large')


def _container_header(n: int, fix: int, b16: int, b32: int) -> bytes:
    if n <= 0x0f:
        return struct.pack('B', fix | n)
    if n <= 0xffff:
        return struct.pack('>BH', b16, n)
    return struct.pack('>BI', b32, n)


def _pack_plain(obj) -> bytes:
    """msgpack.packb of a small plain value (ints, floats, str, lists)."""
    p = _Packer()
    p.pack(obj)
    return b''.join(p.parts)


def _ndarray_parts(arr: np.ndarray) -> List[Any]:
    """flax's _ndarray_to_bytes: packb((shape, dtype name, C bytes)), the
    data as a memoryview of a C-contiguous array."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError('Object and structured dtypes not supported '
                         'for serialization of ndarrays.')
    data = np.ascontiguousarray(arr)
    head = (b'\x93' + _pack_plain([int(d) for d in arr.shape])
            + _pack_plain(arr.dtype.name) + _bin_header(data.nbytes))
    return [head, memoryview(data.reshape(-1).view(np.uint8))]


def _sorted_tree(x):
    """jax.tree_util.tree_map(lambda x: x, tree): dicts rebuilt with their
    keys sorted, lists kept; a tuple stays a tuple (and the packer
    rejects it, as msgpack's strict types do)."""
    if type(x) is dict:
        return {k: _sorted_tree(x[k]) for k in sorted(x)}
    if type(x) is list:
        return [_sorted_tree(v) for v in x]
    if type(x) is tuple:
        return tuple(_sorted_tree(v) for v in x)
    return x


def _chunk_leaves(d):
    """flax's _chunk_array_leaves_in_place on a fresh tree."""
    def chunk(arr):
        size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
        flat = arr.reshape(-1)
        return {'__msgpack_chunked_array__': True,
                'shape': {str(i): int(s) for i, s in enumerate(arr.shape)},
                'chunks': {str(i): flat[j:j + size] for i, j in
                           enumerate(range(0, flat.size, size))}}

    if isinstance(d, dict):
        for k, v in d.items():
            if isinstance(v, np.ndarray):
                if v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
                    d[k] = chunk(v)
            elif isinstance(v, dict):
                _chunk_leaves(v)
    elif isinstance(d, np.ndarray) and d.size * d.dtype.itemsize \
            > MAX_CHUNK_SIZE:
        return chunk(d)
    return d


def _asarray_leaves(x):
    """jax.tree.map(np.asarray, variables): every leaf an ndarray (None is
    an empty subtree and stays None)."""
    if type(x) is dict:
        return {k: _asarray_leaves(v) for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(_asarray_leaves(v) for v in x)
    return None if x is None else np.asarray(x)


def serialize_parts(tree) -> List[Any]:
    """flax.serialization.msgpack_serialize(tree), as a list of byte
    strings and memoryviews to be written in order."""
    p = _Packer()
    p.pack(_chunk_leaves(_sorted_tree(tree)))
    return p.parts


def msgpack_serialize(tree) -> bytes:
    """flax.serialization.msgpack_serialize(tree), byte for byte."""
    return b''.join(bytes(part) for part in serialize_parts(tree))


def save_params(path: str, variables: Dict[str, Any],
                meta: Dict[str, Any] | None = None) -> None:
    """mec_tpu/convert/store.py::save_params: write-to-temp and an atomic
    rename, so a live artifact re-saved in place (the engine persisting
    its int8 scales) is never left truncated."""
    parts = serialize_parts({'variables': _asarray_leaves(variables),
                             'meta': meta or {}})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f'{path}.tmp.{os.getpid()}'
    try:
        with open(tmp, 'wb') as f:
            f.write(MAGIC)
            f.writelines(parts)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------

# bin 8/16/32: the length's struct format and size
_BIN_LENGTH = {0xc4: ('>B', 1), 0xc5: ('>H', 2), 0xc6: ('>I', 4)}


class _Unpacker:
    """msgpack.unpackb(raw=False) with flax's ext hook over a memoryview;
    ``pos`` walks the buffer, so no bytes object is sliced twice."""

    def __init__(self, buf):
        self.buf = memoryview(buf).cast('B')
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        a = self.pos
        if a + n > len(self.buf):
            raise ValueError('msgpack data is truncated')
        self.pos = a + n
        return self.buf[a:a + n]

    def _num(self, fmt: str, n: int):
        return struct.unpack(fmt, self._take(n))[0]

    def unpack(self):
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _BIN_LENGTH:
            return bytes(self._take(self._num(*_BIN_LENGTH[b])))
        if b in (0xc7, 0xc8, 0xc9):
            return self._ext(self._num(*{0xc7: ('>B', 1), 0xc8: ('>H', 2),
                                         0xc9: ('>I', 4)}[b]))
        fmt = {0xca: ('>f', 4), 0xcb: ('>d', 8), 0xcc: ('>B', 1),
               0xcd: ('>H', 2), 0xce: ('>I', 4), 0xcf: ('>Q', 8),
               0xd0: ('>b', 1), 0xd1: ('>h', 2), 0xd2: ('>i', 4),
               0xd3: ('>q', 8)}
        if b in fmt:
            return self._num(*fmt[b])
        if b in (0xd9, 0xda, 0xdb):
            return self._str(self._num(*{0xd9: ('>B', 1), 0xda: ('>H', 2),
                                         0xdb: ('>I', 4)}[b]))
        if b in (0xdc, 0xdd):
            return self._array(self._num('>H' if b == 0xdc else '>I',
                                         2 if b == 0xdc else 4))
        if b in (0xde, 0xdf):
            return self._map(self._num('>H' if b == 0xde else '>I',
                                       2 if b == 0xde else 4))
        raise ValueError(f'msgpack: unknown type byte 0x{b:02x}')

    def _str(self, n: int) -> str:
        return str(self._take(n), 'utf-8')

    def _array(self, n: int) -> list:
        return [self.unpack() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out

    def _ext(self, n: int):
        code = self._num('>b', 1)
        data = self._take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        if code == EXT_COMPLEX:
            re_, im = _Unpacker(data).unpack()
            return complex(re_, im)
        return ExtType(code, bytes(data))


def _ndarray_from(data: memoryview) -> np.ndarray:
    """flax's _ndarray_from_bytes, copied out of the buffer."""
    inner = _Unpacker(data)
    if inner._take(1)[0] != 0x93:
        raise ValueError('ndarray ext: expected (shape, dtype, bytes)')
    shape = inner.unpack()
    name = inner.unpack()
    if name not in _DTYPES:
        raise ValueError(f'.mecp array of dtype {name!r}: not readable '
                         'without jax (expected one of '
                         f'{sorted(_DTYPES)})')
    # the data's bin header read here, so the bytes are copied once
    head = inner._take(1)[0]
    if head not in _BIN_LENGTH:
        raise ValueError('ndarray ext: expected bin data')
    buf = inner._take(inner._num(*_BIN_LENGTH[head]))
    return np.frombuffer(buf, dtype=_DTYPES[name]).reshape(shape).copy()


def _unchunk_leaves(d):
    """flax's _unchunk_array_leaves_in_place."""
    def unchunk(c):
        shape = tuple(c['shape'][str(i)] for i in range(len(c['shape'])))
        flat = np.concatenate([c['chunks'][str(i)]
                               for i in range(len(c['chunks']))])
        return flat.reshape(shape)

    if isinstance(d, dict):
        if '__msgpack_chunked_array__' in d:
            return unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and '__msgpack_chunked_array__' in v:
                d[k] = unchunk(v)
            elif isinstance(v, dict):
                _unchunk_leaves(v)
    return d


def msgpack_restore(encoded) -> Any:
    """flax.serialization.msgpack_restore, with writable arrays."""
    u = _Unpacker(encoded)
    out = u.unpack()
    if u.pos != len(u.buf):
        raise ValueError(f'msgpack: {len(u.buf) - u.pos} bytes after the '
                         'object')
    return _unchunk_leaves(out)


def load_params(path: str) -> Dict[str, Any]:
    """mec_tpu/convert/store.py::load_params: {'variables', 'meta'}. The
    file is read in one call and parsed through a memoryview."""
    with open(path, 'rb') as f:
        blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError(f'{path} is not a mec_tpu params file')
    return msgpack_restore(memoryview(blob)[len(MAGIC):])


def native_path(reference_path: str) -> str:
    """models/speech_model.h5 -> models/speech_model.mecp etc."""
    return os.path.splitext(reference_path)[0] + '.mecp'
