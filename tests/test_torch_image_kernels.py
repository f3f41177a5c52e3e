"""Port kernels K6 (max_pool_3x3s2) and K7 (layer1) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas function in interpret mode, as tests/test_pallas_pool.py and
tests/test_pallas_resnet.py run it, and the JAX modules the kernels
stand in for. Inputs are made with numpy from a seed and handed to both
packages; layer1's parameters follow the JAX test's _quant_params recipe
(serving/synthetic_artifacts.layer1_quant_params). Tolerances:

* pool: bit-exact against the Pallas kernel and against flax's
  nn.max_pool (a max moves values), including all-zero windows, ties,
  and an odd size (nn.max_pool only: the Pallas kernel takes even H=W);
* layer1 against layer1_pallas: the JAX test's own band (atol 2e-2, mean
  < 1e-3, test_pallas_resnet.py:65-66), because the Pallas kernel
  quantizes by a reciprocal multiply where QuantConv divides;
* layer1 against the JAX Bottleneck x3 QuantConv-static path (applied
  eagerly, op by op): bit-exact.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.models.resnet import Bottleneck as JaxBottleneck
from mec_tpu.ops.pallas_pool import max_pool_3x3s2 as pool_pallas
from mec_tpu.ops.pallas_resnet import layer1_pallas
from mec_tpu_torch.convert.from_jax import image_state_from_jax
from mec_tpu_torch.models.resnet import Bottleneck
from mec_tpu_torch.ops import pool_kernel, resnet_kernel
from mec_tpu_torch.ops._build import SM_COUNT
from mec_tpu_torch.serving.synthetic_artifacts import layer1_quant_params


def _bf16_pair(x):
    """One f32 numpy array as a torch bf16 and a jax bf16 array (both
    round to nearest even)."""
    return (torch.from_numpy(x).to(torch.bfloat16),
            jnp.asarray(x, jnp.bfloat16))


def _as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize('case', ['random', 'zeros', 'ties'])
def test_pool_plain_matches_pallas_and_flax(case):
    shape = (2, 16, 16, 8)
    x = {'random': np.abs(np.random.RandomState(0).randn(*shape)),
         'zeros': np.zeros(shape),
         'ties': np.ones(shape)}[case].astype(np.float32)
    xt, xj = _bf16_pair(x)
    got = pool_kernel.max_pool_3x3s2(xt)
    ref = fnn.max_pool(xj, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
    assert got.shape == ref.shape == (2, 8, 8, 8)
    np.testing.assert_array_equal(_as_np(got), _as_np(ref))
    np.testing.assert_array_equal(_as_np(got), _as_np(pool_pallas(xj)))


def test_pool_plain_odd_size_and_negative_values():
    """-inf padding: the result holds for any sign and odd H, W."""
    x = np.random.RandomState(1).randn(2, 15, 9, 8).astype(np.float32)
    xt, xj = _bf16_pair(x)
    got = pool_kernel.max_pool_3x3s2(xt)
    ref = fnn.max_pool(xj, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
    assert got.shape == ref.shape == (2, 8, 5, 8)
    np.testing.assert_array_equal(_as_np(got), _as_np(ref))


def _port_blocks(params):
    state = image_state_from_jax({'params': params})
    blocks = []
    for b in range(3):
        blk = Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0,
                         dtype=torch.bfloat16, fold_bn=True, quant=True,
                         quant_mode='static')
        blk.load_state_dict({k.split('.', 1)[1]: v for k, v in state.items()
                             if k.startswith(f'layer1_{b}.')})
        blocks.append(blk)
    return blocks


class _JaxLayer1(fnn.Module):
    @fnn.compact
    def __call__(self, h):
        for block in range(3):
            h = JaxBottleneck(64, stride=1, downsample=(block == 0),
                              dtype=jnp.bfloat16, fold_bn=True, quant=True,
                              quant_mode='static',
                              name=f'layer1_{block}')(h)
        return h


@pytest.fixture(scope='module')
def layer1_case():
    params = layer1_quant_params(seed=0)
    x = np.abs(np.random.RandomState(1).randn(2, 56, 56, 64)
               ).astype(np.float32)
    xt, xj = _bf16_pair(x)
    jparams = {b: {c: {k: jnp.asarray(v) for k, v in node.items()}
                   for c, node in convs.items()}
               for b, convs in params.items()}
    with torch.inference_mode():
        got = resnet_kernel.layer1(xt, _port_blocks(params))
    return {'got': _as_np(got), 'x': xj, 'params': jparams}


def test_layer1_plain_matches_pallas_kernel(layer1_case):
    ref = _as_np(layer1_pallas(layer1_case['x'], layer1_case['params']))
    got = layer1_case['got']
    assert got.shape == ref.shape == (2, 56, 56, 256)
    np.testing.assert_allclose(got, ref, atol=2e-2)
    assert np.mean(np.abs(got - ref)) < 1e-3


def test_layer1_plain_matches_quantconv_path(layer1_case):
    ref = _as_np(_JaxLayer1().apply({'params': layer1_case['params']},
                                    layer1_case['x']))
    np.testing.assert_array_equal(layer1_case['got'], ref)


@pytest.mark.parametrize('m', [1, 3136, 6272, 16895, 16896, 100352])
def test_pixel_tile_fills_the_card(m):
    """The pixels a block of the CUDA kernel takes: 128 where that still
    gives every SM a block, else 16 (one 224 px image: 196 blocks)."""
    tile = resnet_kernel.pixel_tile(m)
    assert tile in resnet_kernel.PIXEL_TILES
    blocks = -(-m // tile)
    assert (blocks - 1) * tile < m <= blocks * tile     # each pixel once
    if tile == 128:
        assert blocks >= SM_COUNT
    else:
        assert -(-m // 128) < SM_COUNT
    if m >= 3136:
        assert blocks >= SM_COUNT


def test_layer1_pointer_tables_read_the_quantconv_buffers_in_place():
    """The tensor-core kernel takes the QuantConv buffers as they lie
    (weights (Cout, kh*kw*Cin), Cin fastest: the mma's row.col form), so
    nothing is repacked: the four tables hold the modules' own pointers
    in CONV_ORDER. They are kept per model while the blocks hold the
    very tensors that were checked, and rebuilt when one is replaced."""
    blocks = _port_blocks(layer1_quant_params(seed=0))
    cpu = torch.device('cpu')
    tables = resnet_kernel._pointer_tables(blocks, cpu)
    assert resnet_kernel._pointer_tables(blocks, cpu) is tables
    convs = resnet_kernel._convs(blocks)
    for table, name in zip(tables, resnet_kernel._BUFFERS):
        assert list(table) == [getattr(c, name).data_ptr() for c in convs]
    for (b, cname), c in zip(resnet_kernel.CONV_ORDER, convs):
        assert c is getattr(blocks[b], cname)
        assert c.kernel_q.shape == (c.cout, c.k * c.k * c.cin)
        assert c.kernel_q.dtype == torch.int8 and c.kernel_q.is_contiguous()
    # a scale recalibrated in place keeps its pointer: same tables
    convs[4].act_scale.fill_(0.5)
    assert resnet_kernel._pointer_tables(blocks, cpu) is tables
    # a replaced buffer: new tables with the new pointer
    convs[5].register_buffer('bias', convs[5].bias.clone())
    fresh = resnet_kernel._pointer_tables(blocks, cpu)
    assert fresh is not tables
    assert fresh[2][5] == convs[5].bias.data_ptr()
    with pytest.raises(ValueError, match='not contiguous'):
        resnet_kernel._pointer_tables(blocks, torch.device('meta'))


def test_layer1_wrapper_checks_its_blocks():
    blocks = _port_blocks(layer1_quant_params(seed=0))
    with pytest.raises(ValueError, match=r'\(B, H, W, 64\)'):
        resnet_kernel.layer1(torch.zeros(1, 8, 8, 32, dtype=torch.bfloat16),
                             blocks)
    with pytest.raises(ValueError, match='expected 3 blocks'):
        resnet_kernel._convs(blocks[:2])
    dyn = Bottleneck(64, 64, downsample=True, dtype=torch.bfloat16,
                     fold_bn=True, quant=True, quant_mode='dynamic')
    with pytest.raises(ValueError, match='not a static'):
        resnet_kernel._convs([dyn] + blocks[1:])
