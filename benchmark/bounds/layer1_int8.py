"""K7 layer1 (csrc/layer1_int8.cu): ResNet50's layer1, three int8-static
bottlenecks (ten convs) on (B, 56, 56, 64) bfloat16, in seven launches
of three kernels. Bytes: the input read once, each conv's int8 kernel,
float32 per-channel scale and bias and its activation scale read once,
the (B, 56, 56, 256) bfloat16 output written once. Operations: 2 x the
convs' multiply-adds on the int8 tensor cores."""

from benchmark.harness.peaks import bound_ms as _bound

GLOBALS = ('conv1x1_in_kernel', 'conv3x3_kernel', 'conv256_kernel')
COUNTER = ('mec_tpu_torch.ops.resnet_kernel', 'layer1')
LAUNCHES = 7
# (cin, cout, k) of layer1_0 conv1, conv2, conv3, downsample, then twice
# conv1, conv2, conv3 of layer1_1 and layer1_2
CONVS = ((64, 64, 1), (64, 64, 3), (64, 256, 1), (64, 256, 1)) \
    + 2 * ((256, 64, 1), (64, 64, 3), (64, 256, 1))


def bound_ms(batch: int) -> float:
    m = batch * 56 * 56
    weights = sum(ci * co * k * k for ci, co, k in CONVS)
    moved = (m * 64 * 2 + weights + sum(8 * co + 4 for _ci, co, _k in CONVS)
             + m * 256 * 2)
    return _bound(moved, 2 * m * weights, 'int8_tc')[0]
