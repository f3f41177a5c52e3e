"""The port's image modules (mec_tpu_torch) against the JAX package.

Same numpy-seeded inputs and parameter trees through both packages on
the CPU; the JAX modules are applied eagerly (op by op) unless stated.
Tolerances, each with its reason:

* YUV 4:2:0 encode: equal (a numpy copy); decode: 1e-4 (f32 arithmetic
  in two frameworks, values in [0, 255]);
* image decode and the host-side normalize helpers: equal (numpy copies);
* fold and quantize: identical trees (numpy copies);
* QuantConv (1x1, 3x3 stride 2, 1x1 stride 2 downsample; dynamic and
  static): bit-exact, since both divide, round half to even, sum
  integers exactly and round once per op;
* ImageEmotionModel fp32 (live BN): logits and feat 1e-4, the port's
  parity contract;
* ImageEmotionModel bf16 + int8 static against the eager JAX module:
  atol 2e-3, one bf16 step at the head's typical magnitude (0.25-0.5).
  The 52 int8 convs are exact, but the bf16 stem conv and head GEMMs
  accumulate in other orders in oneDNN and XLA:CPU (measured: logits
  equal, 1 of 2048 feat values off by 4.9e-4, a small fc1 output that
  cancels larger bf16 terms);
* calibrated static scales: rtol 5e-2 against calibrate_static_scales,
  which runs the dynamic model under jax.jit, where XLA contracts the
  dequant multiply-add into an FMA and so rounds some bf16 activations
  one step away from the eager path; a one-step change in a layer's
  max-abs moves its scale by up to 2**-7, and the changes compound down
  the network (measured up to 1.9% at 32 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mec_tpu.image import preprocess as jpre
from mec_tpu.models.qconv import QuantConv as JaxQuantConv
from mec_tpu.models.resnet import ImageEmotionModel as JaxModel
from mec_tpu.ops import fold as jfold
from mec_tpu.ops import quant as jquant
from mec_tpu.serving import wire as jwire
from mec_tpu_torch.convert.from_jax import image_state_from_jax
from mec_tpu_torch.image import preprocess as tpre
from mec_tpu_torch.models.qconv import QuantConv
from mec_tpu_torch.models.resnet import ImageEmotionModel
from mec_tpu_torch.ops import fold, quant
from mec_tpu_torch.serving import wire
from mec_tpu_torch.serving.synthetic_artifacts import image_variables


def _imgs(n, size, seed=0):
    rng = np.random.RandomState(seed)
    h = w = size
    grad = np.broadcast_to(np.linspace(0, 255, w)[None, :, None], (h, w, 3))
    frames = [rng.randint(0, 256, (h, w, 3)), grad,
              np.full((h, w, 3), [255, 0, 0]),
              ((np.indices((h, w)).sum(0) // 4) % 2 * 255)[:, :, None]
              * np.ones(3)]
    frames += [rng.randint(0, 256, (h, w, 3)) for _ in range(n - 4)]
    return np.stack(frames[:n]).astype(np.uint8)


def _normalized(imgs):
    x = imgs.astype(np.float32) / 255.0
    return ((x - jpre.IMAGENET_MEAN) / jpre.IMAGENET_STD).astype(np.float32)


def _trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope='module')
def trees():
    tree, meta = image_variables(seed=1, image_size=32)
    folded = fold.fold_conv_bn(tree)
    return {'tree': tree, 'folded': folded,
            'quant': quant.quantize_image_params(folded)}


# ----------------------------------------------------------------------
# copies pinned to their originals
# ----------------------------------------------------------------------

def test_yuv420_encode_equal_decode_close():
    imgs = _imgs(5, 32)
    y8, uv8 = wire.encode_yuv420_np(imgs)
    jy, juv = jwire.encode_yuv420_np(imgs)
    np.testing.assert_array_equal(y8, jy)
    np.testing.assert_array_equal(uv8, juv)
    got = wire.decode_yuv420(torch.from_numpy(y8), torch.from_numpy(uv8))
    ref = np.asarray(jwire.decode_yuv420(jnp.asarray(jy), jnp.asarray(juv)))
    assert got.shape == (5, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_preprocess_copy_matches_original(tmp_path):
    from PIL import Image
    np.testing.assert_array_equal(tpre.IMAGENET_MEAN, jpre.IMAGENET_MEAN)
    np.testing.assert_array_equal(tpre.IMAGENET_STD, jpre.IMAGENET_STD)
    path = str(tmp_path / 'a.png')
    Image.fromarray(_imgs(1, 40)[0]).save(path)
    np.testing.assert_array_equal(tpre.load_image_uint8(path, (24, 32)),
                                  jpre.load_image_uint8(path, (24, 32)))


@pytest.mark.parametrize('normalized', [True, False])
def test_host_normalize_helpers_match_original(tmp_path, normalized):
    """normalize_uint8 and load_image_for_model are numpy copies: equal."""
    from PIL import Image
    img = _imgs(2, 40)
    np.testing.assert_array_equal(tpre.normalize_uint8(img),
                                  jpre.normalize_uint8(img))
    path = str(tmp_path / 'a.png')
    Image.fromarray(img[1]).save(path)
    got = tpre.load_image_for_model(path, (24, 32), normalized=normalized)
    want = jpre.load_image_for_model(path, (24, 32), normalized=normalized)
    assert got.dtype == want.dtype and got.shape == (24, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_fold_and_quantize_copies_give_identical_trees(trees):
    _trees_equal(trees['folded'], jfold.fold_conv_bn(trees['tree']))
    _trees_equal(trees['quant'], jquant.quantize_image_params(
        jfold.fold_conv_bn(trees['tree'])))
    scales = {k: 0.01 * (i + 1) for i, k in enumerate(
        ['layer1_0/conv1'])}
    with pytest.raises(ValueError, match='missing'):
        quant.insert_static_scales(trees['quant'], scales)
    with pytest.raises(ValueError, match='no \\(conv, bn\\) pairs'):
        fold.fold_conv_bn({'params': {'fc1': {'kernel': np.zeros((2, 2))}}})
    with pytest.raises(ValueError, match='BN-folded'):
        quant.quantize_image_params(trees['tree'])


def test_static_scale_tree_roundtrip_matches_original(trees):
    keys = []

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict) and 'kernel_q' in v:
                keys.append(prefix + k)
            elif isinstance(v, dict):
                walk(v, prefix + k + '/')
    walk(trees['quant']['params'], '')
    assert len(keys) == 52        # 16 blocks x 3 convs + 4 downsamples
    scales = {k: 0.001 * (i + 1) for i, k in enumerate(keys)}
    got = quant.insert_static_scales(trees['quant'], scales)
    _trees_equal(got, jquant.insert_static_scales(trees['quant'], scales))
    assert quant.extract_static_scales(got) == \
        jquant.extract_static_scales(got) == \
        {k: float(np.float32(v)) for k, v in scales.items()}


# ----------------------------------------------------------------------
# QuantConv
# ----------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['dynamic', 'static'])
@pytest.mark.parametrize('cin,cout,k,stride', [
    (16, 24, 1, 1),      # bottleneck conv1 / conv3
    (16, 16, 3, 2),      # stride-2 conv2 of a stage's first block
    (16, 32, 1, 2),      # the stride-2 downsample
])
def test_quantconv_matches_jax(mode, cin, cout, k, stride):
    rng = np.random.RandomState(cin + cout + k + stride)
    node = quant.quantize_conv({
        'kernel': (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32),
        'bias': (rng.randn(cout) * 0.1).astype(np.float32)})
    if mode == 'static':
        node['act_scale'] = np.float32(0.02)
    x = rng.randn(3, 9, 10, cin).astype(np.float32)
    x[2] = 0.0                            # a padded bucket row
    pad = 1 if k == 3 else 0
    jconv = JaxQuantConv(cout, (k, k), strides=(stride, stride),
                         padding=((pad, pad), (pad, pad)) if pad else 'SAME',
                         dtype=jnp.bfloat16, mode=mode)
    ref = jconv.apply({'params': {k_: jnp.asarray(v)
                                  for k_, v in node.items()}},
                      jnp.asarray(x, jnp.bfloat16))
    conv = QuantConv(cin, cout, k, stride, pad, mode, torch.bfloat16)
    conv.load_state_dict({n.split('.', 1)[1]: v for n, v in
                          image_state_from_jax({'params': {'c': node}})
                          .items()})
    got = conv(torch.from_numpy(x).to(torch.bfloat16))
    assert tuple(got.shape) == ref.shape and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert bool((got[2] == got[2][0, 0]).all())   # zero row: bias only


# ----------------------------------------------------------------------
# the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize('size', [32, 64])
def test_fp32_model_matches_jax(size):
    tree, _ = image_variables(seed=2, image_size=size)
    x = _normalized(_imgs(4, size, seed=size))
    jl, jf = JaxModel().apply(tree, jnp.asarray(x))
    model = ImageEmotionModel()
    model.load_state_dict(image_state_from_jax(tree))
    with torch.inference_mode():
        logits, feat = model(torch.from_numpy(x))
    assert logits.shape == (4, 7) and feat.shape == (4, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jf), atol=1e-4)


def test_int8_static_model_and_calibration_match_jax(trees):
    x = _normalized(_imgs(4, 32))
    dyn = ImageEmotionModel(dtype=torch.bfloat16, fold_bn=True, quant=True)
    dyn.load_state_dict(image_state_from_jax(trees['quant']))
    runs = quant.CALIBRATION_RUNS
    cal = quant.calibrate_static_scales(dyn, trees['quant'],
                                        torch.from_numpy(x))
    assert quant.CALIBRATION_RUNS == runs + 1
    jcal = jquant.calibrate_static_scales(
        JaxModel(dtype=jnp.bfloat16, fold_bn=True, quant=True),
        trees['quant'], (jnp.asarray(x),))
    got, ref = (quant.extract_static_scales(c) for c in (cal, jcal))
    assert set(got) == set(ref) and len(got) == 52
    for k in ref:
        assert abs(got[k] - ref[k]) <= 5e-2 * ref[k], k

    static = ImageEmotionModel(dtype=torch.bfloat16, fold_bn=True,
                               quant=True, quant_mode='static')
    static.load_state_dict(image_state_from_jax(cal))
    with torch.inference_mode():
        logits, feat = static(torch.from_numpy(x))
    jl, jf = JaxModel(dtype=jnp.bfloat16, fold_bn=True, quant=True,
                      quant_mode='static').apply(
        jax.tree_util.tree_map(jnp.asarray, cal), jnp.asarray(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-3)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jf), atol=2e-3)
