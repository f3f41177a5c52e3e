"""ctypes binding of the native WordPiece encoder (wordpiece.cpp).

A copy of mec_tpu/native/tokenizer.py. NativeWordPiece wraps the C++
batch encoder; accelerate() gives a lower-casing
mec_tpu_torch.text.wordpiece.WordPieceTokenizer a native encode_batch
for batches that are all ASCII and free of NUL characters (a NUL would
end the C string), and leaves every other batch to the Python encoder,
which stays the meaning.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np

from mec_tpu_torch.native.build import load_library

_I32P = ctypes.POINTER(ctypes.c_int32)


class NativeWordPiece:
    def __init__(self, vocab: Dict[str, int], unk_id: int, cls_id: int,
                 sep_id: int, pad_id: int):
        self._lib = load_library('wordpiece')
        if self._lib is None:
            raise RuntimeError('native wordpiece unavailable (no g++)')
        lib = self._lib
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), _I32P,
                                  ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32]
        lib.wp_destroy.restype = None
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_encode_batch.restype = None
        lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32, ctypes.c_int32, _I32P, _I32P]
        items = list(vocab.items())
        tokens = [t.encode('utf-8') for t, _ in items]
        arr = (ctypes.c_char_p * len(items))(*tokens)
        ids = np.asarray([i for _, i in items], np.int32)
        # wp_create copies the tokens into its own table
        self._handle = lib.wp_create(arr, ids.ctypes.data_as(_I32P),
                                     len(items), unk_id, cls_id, sep_id,
                                     pad_id)

    def __del__(self):
        lib = getattr(self, '_lib', None)
        handle = getattr(self, '_handle', None)
        if lib is not None and handle:
            lib.wp_destroy(handle)

    def encode_batch(self, texts: List[str], max_length: int = 128
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """ASCII, NUL-free texts -> (ids, mask), each (n, max_length)
        int32, as WordPieceTokenizer.encode_batch gives them."""
        n = len(texts)
        ids = np.empty((n, max_length), np.int32)
        mask = np.empty((n, max_length), np.int32)
        raw = [t.encode('utf-8') for t in texts]
        arr = (ctypes.c_char_p * n)(*raw)
        self._lib.wp_encode_batch(self._handle, arr, n, max_length,
                                  ids.ctypes.data_as(_I32P),
                                  mask.ctypes.data_as(_I32P))
        return ids, mask


def accelerate(tokenizer) -> bool:
    """Give a lower-casing WordPieceTokenizer the native fast path for
    ASCII, NUL-free batches (the only input the C++ encoder implements);
    True when the library loaded, False for a cased tokenizer or a host
    without g++."""
    if not tokenizer.do_lower_case or load_library('wordpiece') is None:
        return False
    native = NativeWordPiece(tokenizer.vocab, tokenizer.unk_id,
                             tokenizer.cls_id, tokenizer.sep_id,
                             tokenizer.pad_id)
    python_encode_batch = tokenizer.encode_batch

    def fast_encode_batch(texts, max_length: int = 128):
        if all(isinstance(t, str) and t.isascii() and '\x00' not in t
               for t in texts):
            return native.encode_batch(list(texts), max_length)
        return python_encode_batch(texts, max_length)

    tokenizer.encode_batch = fast_encode_batch
    tokenizer._native = native
    return True
