"""Data-sheet peaks of one NVIDIA H100 SXM (dense, without sparsity, at
the full 700 W limit): bytes/s of HBM3 and operations/s by unit."""

PEAKS = {'memory': 3.35e12, 'fp32': 67e12, 'tf32_tc': 495e12,
         'bf16_tc': 989e12, 'fp8_tc': 1979e12, 'int8_tc': 1979e12}


def bound_ms(moved_bytes: float, ops: float, unit: str):
    """The least time (ms) the card could take: the larger of the bytes
    (each input read once, each output written once) over the memory
    rate and the operations over the unit's peak. -> (ms, 'bytes' or
    'operations')."""
    t_bytes = moved_bytes / PEAKS['memory'] * 1e3
    t_ops = ops / PEAKS[unit] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
