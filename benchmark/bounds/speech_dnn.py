"""K4 speech_dnn (csrc/speech_dnn.cu): the BatchNorm-folded SpeechDNN
56 -> 512 -> 512 -> 256 -> 128 -> 64 -> 7 on B standardized feature rows.
Bytes: the (B, 56) input, the folded weights and biases (float32) read
once, the packed (B, 128) float32 row written. Operations: 2 x the
multiply-adds; float32."""

from benchmark.harness.peaks import bound_ms as _bound

GLOBALS = ('speech_dnn_kernel',)
COUNTER = ('mec_tpu_torch.ops.speech_kernels', 'speech_dnn')
LAUNCHES = 1
DIMS = (56, 512, 512, 256, 128, 64, 7)


def bound_ms(batch: int) -> float:
    macs = sum(a * b for a, b in zip(DIMS, DIMS[1:]))
    params = macs + sum(DIMS[1:])
    moved = batch * DIMS[0] * 4 + params * 4 + batch * 128 * 4
    return _bound(moved, 2 * batch * macs, 'fp32')[0]
