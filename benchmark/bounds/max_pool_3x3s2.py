"""K6 max_pool_3x3s2 (csrc/max_pool_3x3s2.cu): ResNet50's stem pool,
(B, 112, 112, 64) bfloat16 NHWC -> (B, 56, 56, 64). Bytes: the input read
once, the output written once. Operations: 8 compares an output; the
bound is the bytes'."""

from benchmark.harness.peaks import bound_ms as _bound

GLOBALS = ('max_pool_3x3s2_kernel',)
COUNTER = ('mec_tpu_torch.ops.pool_kernel', 'max_pool_3x3s2')
LAUNCHES = 1


def bound_ms(batch: int) -> float:
    stem, pooled = batch * 112 * 112 * 64, batch * 56 * 56 * 64
    return _bound(2 * (stem + pooled), 8 * pooled, 'fp32')[0]
