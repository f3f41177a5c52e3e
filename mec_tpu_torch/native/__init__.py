"""Native (C++) host runtime: copies of mec_tpu/native/.

  * wirecodec.cpp: the 12-bit PCM and YUV 4:2:0 wire encoders
    (serving/wire.py::encode_pcm12, encode_yuv420);
  * wordpiece.cpp: the batch WordPiece encoder (tokenizer.py::accelerate);
  * audiofeat.cpp: the 56-dim audio featurizer (featurizer.py::extract56),
    behind MEC_HOST_AUDIO_FEATURES.

Each library is built with g++ at first use (build.py) and bound with
ctypes; its numpy or Python version is the meaning, runs where g++ is
absent, and is pinned against it by tests/test_torch_native.py.
status() says which libraries loaded.
"""

from mec_tpu_torch.native.build import load_library, status

__all__ = ['load_library', 'status']
