"""K2 tuning_select (csrc/tuning_select.cu): per clip, the median
candidate magnitude and the 100-bin residual histogram's first maximum
over (B, 130 * 179) candidates (magnitudes, residuals, pitches, float32).
Bytes: the three candidate arrays read once, the bin (int32) and flag
(bool) written. Operations: the reference's 32 bisection probes and 101
histogram edges, one compare each; float32."""

from benchmark.harness.peaks import bound_ms as _bound

GLOBALS = ('tuning_select_kernel',)
COUNTER = ('mec_tpu_torch.ops.tuning_kernel', 'tuning_select')
LAUNCHES = 1
CANDIDATES = 130 * 179     # frames x the compacted 150-4000 Hz band


def bound_ms(batch: int) -> float:
    n = batch * CANDIDATES
    return _bound(3 * n * 4 + batch * 5, (32 + 101) * n, 'fp32')[0]
