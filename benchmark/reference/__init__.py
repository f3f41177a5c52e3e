"""Plain float32 reference of every stage a tri-modal request passes through.

Imports torch, numpy, PIL and the benchmark's seeded leaves
(benchmark/weights/seeded.py) only: nothing of jax, mec_tpu or
mec_tpu_torch.
"""
