"""mec_tpu_torch — the PyTorch/CUDA port of mec_tpu, for NVIDIA Hopper.

The JAX package `mec_tpu` stays beside this one as the reference; every
module here mirrors the path of its `mec_tpu` counterpart and is held
against it by the tests in tests/test_torch_*.py. This package imports
torch and never jax: the machine that runs it on the card has no jax,
flax, msgpack or werkzeug, so the numpy-only host modules it needs
(config, filters, wav, the batcher) are small copies pinned to their
originals by tests.

What is ported so far is the speech serving path: waveform -> 12-bit
PCM wire -> on-device 56-dim frontend -> full-width speech DNN ->
result dicts, with the four TPU Pallas kernels of that path rewritten
as CUDA C++ kernels for sm_90a (csrc/, built at first use by
ops/_build.py).

Package layout:
  config.py   the subset of mec_tpu.config the slice reads
  ops/        frontend (audio_features), kernel wrappers + plain twins,
              numpy filter tables, WAV decode, the nvcc build
  csrc/       the hand-written CUDA kernels
  models/     SpeechDNN (plain nn.Module)
  convert/    JAX (Flax numpy tree) -> port parameters
  serving/    wire codec, engine, micro-batcher
  utils/      StageTimer
"""

import torch

__version__ = "0.1.0"

# The parity contract with the JAX fp32 reference is 1e-4 on features
# and probabilities; TF32 keeps about 3 decimal digits, so fp32 matmuls
# and convolutions must run in full fp32. The matmul flag already
# defaults to False, cuDNN's does not; both are set so the policy is
# explicit.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
