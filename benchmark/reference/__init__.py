"""Plain float32 reference of every stage a tri-modal request passes through.

Imports torch, numpy and PIL only: nothing of jax, mec_tpu or mec_tpu_torch.
"""
