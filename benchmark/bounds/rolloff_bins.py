"""K3 rolloff_bins (csrc/rolloff_bins.cu): for each of B * 130 magnitude
rows of 1025 float32 bins, the first bin whose prefix sum reaches 85% of
the row's total. Bytes: the rows read once, an int32 a row written.
Operations: the total and the prefix sum, an add each; float32."""

from benchmark.harness.peaks import bound_ms as _bound

GLOBALS = ('rolloff_bins_kernel',)
COUNTER = ('mec_tpu_torch.ops.rolloff_kernel', 'rolloff_bins')
LAUNCHES = 1
FRAMES, BINS = 130, 1025


def bound_ms(batch: int) -> float:
    rows = batch * FRAMES
    return _bound(rows * BINS * 4 + rows * 4, 2 * rows * BINS, 'fp32')[0]
