"""The CUDA kernels of mec_tpu_torch against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file
imports no jax, so it runs on the card's machine (which has none):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures jax.) Inputs are the serving
path's shapes at B=1 and B=32 (the four speech kernels K1 to K4 at more
sizes: the middle bucket, tile edges and ragged tails), made from a
numpy seed. Tolerances, each
with its reason: K1 |k - p| <= 1e-4 + 2e-6|p| (summation order and
log10f's last bit; MFCC0 reaches -1131, where one f32 ulp is 1.2e-4);
K2 bit-exact (integer and compare work only); K3 equal bins except
one-bin steps where the f64 prefix is within the worst-case f32 sum
rounding (1025 * 2**-24 of the total) of the threshold; K4 probs
2e-6 and penult 2e-5 (the JAX kernel test's bounds); K6 and K7
bit-exact (a max moves values; K7's integer sums are exact and it rounds
where the plain QuantConv path rounds); K5 in both precisions mag atol
5e-5 and P relative 5e-3 over P + 1e-6 on 0.1-scale noise frames (the
JAX package's K5 contract, tests/test_pallas.py:31-40; kernel and plain
version sum the same exact products in other orders). The image and
tri-modal engines on the card and on the CPU agree in fp32 within 1e-4;
in bf16 int8-static (the CPU engine takes the card engine's scales)
decisions are equal wherever the top-2 margin exceeds the probability
band of 2e-2 (bf16 GEMMs accumulate in other orders on the two devices).
The forest walk parks at the same leaves on both devices (the same fp32
comparisons) and its probabilities agree within 1e-6 (the mean over
trees in another order); MobileNetV2 follows the image bands; a tiny
models directory read by from_models_dir on the card agrees with the
CPU engine over it (fp32 1e-4, and the rf tail within 1e-6 on rows whose
walks park at the same leaves; bf16 rf mode, which takes the card's
scales from the .mecp cache, 5e-2, the MobileNetV2 band of
chip_smoke.py; the rf tail within 1e-6 of the forest on the card's own
softmax outputs).
"""

import numpy as np
import pytest
import torch

from mec_tpu_torch.bench.kernel_ab import narrow_tree, power_of
from mec_tpu_torch.config import Config
from mec_tpu_torch.convert.from_jax import (forest_from_jax,
                                            image_state_from_jax,
                                            mobilenet_state_from_jax)
from mec_tpu_torch.models.forest import forest_apply, forest_leaves
from mec_tpu_torch.models.mobilenet import MobileNetV2EmotionModel
from mec_tpu_torch.models.resnet import Bottleneck
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import (dft_kernel, pool_kernel, resnet_kernel,
                               rolloff_kernel, speech_kernels, tuning_kernel)
from mec_tpu_torch.ops.quant import extract_static_scales
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import (
    bert_variables, forest_arrays, fusion_variables, image_variables,
    layer1_quant_params, make_vocab, mobilenet_variables, speech_variables,
    write_synthetic_artifacts)

N = 66150


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels run only there')
    return torch.device('cuda')


def _waves(B, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 22050.0
    rows = [np.zeros(N)]
    for i in range(1, B):
        f = 150 + 37 * i
        rows.append(0.3 * np.sin(2 * np.pi * f * t) + 0.02 * i * rng.randn(N))
    return np.stack(rows[-B:]).astype(np.float32)


def _spectra(B, dev):
    return af.hop_spectrograms(torch.from_numpy(_waves(B)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 2, 8, 32, 33])
def test_mfcc_mean_kernel(dev, B):
    """Row 0 is the silent clip; from B = 2 on row 1 is a clip whose only
    sound is one loud frame, so the clip's max lives in the frames of
    one block of its cluster. Two runs give the same bits (no atomics)."""
    P = power_of(B, dev, seed=B)
    before = speech_kernels.mfcc_mean.launches
    k = speech_kernels.mfcc_mean(P)
    again = speech_kernels.mfcc_mean(P)
    p = speech_kernels.mfcc_mean_plain(P)
    torch.cuda.synchronize()
    assert speech_kernels.mfcc_mean.launches == before + 2
    assert bool(torch.isfinite(k).all())
    assert bool(((k - p).abs() <= 1e-4 + 2e-6 * p.abs()).all())
    assert torch.equal(k, again)


@pytest.mark.cuda
def test_mfcc_mean_kernel_on_an_offset_view(dev):
    """A clip that starts 4 bytes off a 16-byte boundary (a view into a
    larger buffer, not a copy): the kernel aligns its wide copies itself."""
    base = torch.zeros(3 * 130 * 1025 + 1, device=dev)
    P = base[1:].view(3, 130, 1025)
    P.copy_(power_of(3, dev, seed=7))
    assert P.data_ptr() % 16 == 4 and P.is_contiguous()
    k = speech_kernels.mfcc_mean(P)
    p = speech_kernels.mfcc_mean_plain(P)
    torch.cuda.synchronize()
    assert bool(((k - p).abs() <= 1e-4 + 2e-6 * p.abs()).all())


@pytest.mark.cuda
def test_speech_kernels_from_threads_on_every_card(dev):
    """K1-K4 called from 8 threads at once, on tensors of every visible
    card, with the host thread's current device left at cuda:0 and the
    interpreter switching threads every 10 us: each wrapper launches on
    its tensor's card and each kernel's attributes are granted per card
    under a lock, so every result equals the one computed alone."""
    import sys
    import threading
    cards = [torch.device('cuda', i) for i in range(torch.cuda.device_count())]
    fwd = {c: speech_kernels.make_speech_dnn(speech_variables(seed=2), c)
           for c in cards}

    def run(card, B):
        P = power_of(B, card, seed=B)
        mag, S = af.hop_spectrograms(torch.from_numpy(_waves(B)).to(card))
        mags, pitches = af.tuning_candidates(S)
        x = torch.from_numpy(np.random.RandomState(B).randn(B, 56)
                             .astype(np.float32)).to(card)
        out = (speech_kernels.mfcc_mean(P),
               *tuning_kernel.tuning_select(mags, af.fold_residual(pitches),
                                            pitches),
               rolloff_kernel.rolloff_bins(mag.reshape(-1, mag.shape[-1])),
               fwd[card](x))
        torch.cuda.synchronize(card)
        return [t.cpu() for t in out]

    jobs = [(cards[i % len(cards)], B) for i, B in
            enumerate([1, 33, 8, 32, 2, 17, 4, 64])]
    got, errors = {}, []

    def worker(job):
        torch.cuda.set_device(0)
        try:
            got[job] = run(*job)
        except Exception as e:  # reported below, with the job
            errors.append((job, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(j,)) for j in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    for job in jobs:
        for a, b in zip(got[job], run(*job)):
            assert torch.equal(a, b), job


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 8, 32, 33])
def test_tuning_select_kernel(dev, B):
    """One cluster a clip (8 blocks at B <= 16, 4 at 32 and 33; the last
    block of a cluster streams a shorter slice). Block 0 gathers the
    kept pairs in whatever order the blocks arrive, and two runs still
    give the same bits."""
    _mag, P = _spectra(B, dev)
    mags, pitches = af.tuning_candidates(P)
    residual = af.fold_residual(pitches)
    before = tuning_kernel.tuning_select.launches
    kb, kh = tuning_kernel.tuning_select(mags, residual, pitches)
    kb2, kh2 = tuning_kernel.tuning_select(mags, residual, pitches)
    pb, ph = tuning_kernel.tuning_select_plain(mags, residual, pitches)
    assert tuning_kernel.tuning_select.launches == before + 2
    assert torch.equal(kb, pb) and torch.equal(kh, ph)
    assert torch.equal(kb, kb2) and torch.equal(kh, kh2)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['noise', 'silence', 'every_slot', 'tied',
                                  'signed_zero', 'odd_K'])
def test_tuning_select_kernel_where_its_work_depends_on_the_data(dev, case):
    """Noise (four slots in ten are candidates), silence (none), every
    slot a candidate, a few tied magnitudes (the median's bin outgrows
    the short list, so the radix rounds read every key), magnitudes of
    both zeros, and a K no cluster divides."""
    gen = torch.Generator(device=dev).manual_seed(3)
    K = 130 * 179
    if case in ('noise', 'silence'):
        scale = 0.05 if case == 'noise' else 0.0
        y = scale * torch.randn(4, N, device=dev, generator=gen)
        mags, pitches = af.tuning_candidates(af.hop_spectrograms(y)[1])
        residual = af.fold_residual(pitches)
    else:
        if case == 'odd_K':
            K = 4099
        pitches = torch.rand(3, K, device=dev, generator=gen) + 0.5
        residual = torch.rand(3, K, device=dev, generator=gen) - 0.5
        mags = torch.rand(3, K, device=dev, generator=gen) + 0.5
        if case == 'tied':
            mags = torch.floor(mags * 4)
        if case == 'signed_zero':
            mags = torch.where(mags > 1.0, 0.0, -0.0) * torch.ones_like(mags)
        if case == 'odd_K':
            pitches = pitches * (pitches > 0.8)          # some slots empty
    kb, kh = tuning_kernel.tuning_select(mags, residual, pitches)
    pb, ph = tuning_kernel.tuning_select_plain(mags, residual, pitches)
    assert torch.equal(kb, pb) and torch.equal(kh, ph)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 8, 32, 33])
def test_rolloff_bins_kernel(dev, B):
    """A warp a row; with the all-zero row appended the row count is odd
    against every block size, so the last block is ragged."""
    mag, _P = _spectra(B, dev)
    rows = torch.cat([mag.reshape(-1, 1025),
                      torch.zeros(1, 1025, device=dev)])
    before = rolloff_kernel.rolloff_bins.launches
    k = rolloff_kernel.rolloff_bins(rows)
    p = rolloff_kernel.rolloff_bins_plain(rows)
    assert rolloff_kernel.rolloff_bins.launches == before + 1
    assert k[-1].item() == 0
    for r in torch.nonzero(k != p).flatten().tolist():
        cum = torch.cumsum(rows[r].double(), 0)
        lo = min(k[r].item(), p[r].item())
        assert abs(k[r].item() - p[r].item()) == 1
        assert abs(cum[lo].item() - 0.85 * cum[-1].item()) \
            <= 1025 * 2.0 ** -24 * cum[-1].item()   # f32 sum rounding


@pytest.mark.cuda
@pytest.mark.parametrize('offset,F', [(1, 1025), (2, 1025), (3, 1025),
                                      (0, 1024), (1, 7), (0, 33)])
def test_rolloff_bins_kernel_on_offset_rows_and_other_widths(dev, offset, F):
    """Rows that start off a 16-byte boundary (a view into a larger
    buffer) and widths with other tails: the kernel aligns its wide
    copies itself; against the f64 prefix, bins equal or a one-bin
    near-tie."""
    R = 37
    gen = torch.Generator(device=dev).manual_seed(F + offset)
    base = torch.rand(R * F + offset, device=dev, generator=gen)
    rows = base[offset:].view(R, F)
    assert rows.data_ptr() % 16 == 4 * offset
    k = rolloff_kernel.rolloff_bins(rows)
    cum = torch.cumsum(rows.double(), dim=-1)
    want = (cum >= 0.85 * cum[:, -1:]).float().argmax(dim=-1).to(torch.int32)
    assert int((k - want).abs().max()) <= 1
    for r in torch.nonzero(k != want).flatten().tolist():
        lo = min(k[r].item(), want[r].item())
        assert abs(cum[r, lo].item() - 0.85 * cum[r, -1].item()) \
            <= F * 2.0 ** -24 * cum[r, -1].item()


@pytest.mark.cuda
@pytest.mark.parametrize('network', ['full', 'narrow'])
@pytest.mark.parametrize('B', [1, 8, 9, 32, 33, 64])
def test_speech_dnn_kernel(dev, B, network):
    """Full width (every hidden layer from staged weights) and a narrow
    network (56-32-16-7: too narrow for 16 blocks to share in 4-column
    groups, so its hidden layers take the scalar path)."""
    x = torch.from_numpy(np.random.RandomState(B).randn(B, 56)
                         .astype(np.float32)).to(dev)
    tree = speech_variables() if network == 'full' else narrow_tree()
    fwd = speech_kernels.make_speech_dnn(tree, dev)
    pen = fwd.dims[-2]
    before = speech_kernels.speech_dnn.launches
    k = fwd(x)
    p = speech_kernels.speech_dnn_plain(x, fwd.params, fwd.dims)
    torch.cuda.synchronize()
    assert speech_kernels.speech_dnn.launches == before + 1
    assert (k[:, :7] - p[:, :7]).abs().max().item() <= 2e-6
    assert (k[:, 7:] - p[:, 7:]).abs().max().item() <= 2e-5
    assert bool((k[:, 7 + pen:] == 0).all())
    assert bool((k[:, 71:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize('dims', [(56, 513, 7), (56, 7), (56, 64, 129),
                                  (56,) + (32,) * 8 + (7,)])
def test_speech_dnn_kernel_rejects_shapes_over_its_limits(dev, dims):
    """Wider than 512, fewer than two layers, more than 128 classes, more
    than 8 layers: the launch is refused, nothing falls back."""
    n = sum(a * b + b for a, b in zip(dims, dims[1:]))
    x = torch.zeros(2, 56, device=dev)
    with pytest.raises(RuntimeError, match='speech_dnn: CUDA error'):
        speech_kernels.speech_dnn(x, torch.zeros(n, device=dev), dims)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    P = torch.zeros(1, 130, 1025, device=dev)
    with pytest.raises(TypeError):
        speech_kernels.mfcc_mean(P.double())
    with pytest.raises(ValueError, match='contiguous'):
        rolloff_kernel.rolloff_bins(P[0].t().contiguous().t())
    big = torch.ones(1, tuning_kernel.MAX_K + 1, device=dev)
    with pytest.raises(ValueError, match='shared-memory'):
        tuning_kernel.tuning_select(big, big, big)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_engine_on_cuda_matches_cpu(dev, dtype):
    """fp32: the parity graph (rFFT, cumsum rolloff, live-BN SpeechDNN),
    K2 alone on the card. bf16: the serving graph, K1-K4 once a
    dispatch. The speech leg is fp32 arithmetic in both modes, so the
    card and the CPU differ by summation orders alone."""
    waves = _waves(5, seed=3)
    tree = speech_variables(seed=1)
    feats = af.audio_features_56(torch.from_numpy(_waves(32)), 'high').numpy()
    scaler = (feats.mean(axis=0), feats.std(axis=0) + 1e-3)   # standardize
    cuda_engine = EmotionEngine(tree, scaler, compute_dtype=dtype,
                                device='cuda')
    cpu_engine = EmotionEngine(tree, scaler, compute_dtype=dtype,
                               device='cpu')
    wrappers = (speech_kernels.mfcc_mean, tuning_kernel.tuning_select,
                rolloff_kernel.rolloff_bins, speech_kernels.speech_dnn)
    before = [w.launches for w in wrappers]
    got = cuda_engine.predict_speech_waves(waves, want_features=True)
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    assert launched == ([0, 1, 0, 0] if dtype == 'float32' else [1, 1, 1, 1])
    ref = cpu_engine.predict_speech_waves(waves, want_features=True)
    for g, r in zip(got, ref):
        assert g['emotion'] == r['emotion']
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=1e-4)
        np.testing.assert_allclose(g['_features'], r['_features'], atol=1e-4)


def _layer1_blocks(dev, seed=0):
    state = image_state_from_jax({'params': layer1_quant_params(seed)})
    blocks = []
    for b in range(3):
        blk = Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0,
                         dtype=torch.bfloat16, fold_bn=True, quant=True,
                         quant_mode='static')
        blk.load_state_dict({k.split('.', 1)[1]: v for k, v in state.items()
                             if k.startswith(f'layer1_{b}.')})
        blocks.append(blk.to(dev))
    return blocks


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 112, 112, 64), (32, 112, 112, 64),
                                   (2, 15, 9, 64)])
def test_max_pool_kernel(dev, shape):
    x = torch.from_numpy(np.random.RandomState(shape[0]).randn(*shape)
                         .astype(np.float32)).to(dev, torch.bfloat16)
    x[0, :3] = 0.0                                   # all-zero windows, ties
    before = pool_kernel.max_pool_3x3s2.launches
    k = pool_kernel.max_pool_3x3s2(x)
    p = pool_kernel.max_pool_3x3s2_plain(x)
    torch.cuda.synchronize()
    assert pool_kernel.max_pool_3x3s2.launches == before + 1
    assert k.shape == p.shape == (shape[0], (shape[1] + 1) // 2,
                                  (shape[2] + 1) // 2, 64)
    assert torch.equal(k, p)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 56, 56, 64), (32, 56, 56, 64),
                                   (2, 13, 9, 64), (2, 56, 56, 64),
                                   (3, 57, 55, 64)])
def test_layer1_kernel(dev, shape):
    blocks = _layer1_blocks(dev)
    x = torch.from_numpy(np.abs(np.random.RandomState(1).randn(*shape))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    before = resnet_kernel.layer1.launches
    with torch.inference_mode():
        k = resnet_kernel.layer1(x, blocks)
        p = resnet_kernel.layer1_plain(x, blocks)
    torch.cuda.synchronize()
    assert resnet_kernel.layer1.launches == before + 1
    assert k.shape == p.shape == shape[:3] + (256,)
    assert torch.equal(k, p)


@pytest.mark.cuda
def test_layer1_kernel_reads_scales_recalibrated_in_place(dev):
    """The kernel reads the activation scales through their own pointers:
    new values copied into the same buffers are used by the next call."""
    blocks = _layer1_blocks(dev)
    x = torch.from_numpy(np.abs(np.random.RandomState(2).randn(2, 20, 20, 64))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    with torch.inference_mode():
        first = resnet_kernel.layer1(x, blocks)
        for i, c in enumerate(resnet_kernel._convs(blocks)):
            c.act_scale.mul_(1.0 + 0.1 * (i % 3))
        k = resnet_kernel.layer1(x, blocks)
        p = resnet_kernel.layer1_plain(x, blocks)
    torch.cuda.synchronize()
    assert torch.equal(k, p) and not torch.equal(k, first)


@pytest.mark.cuda
def test_image_engine_on_cuda_matches_cpu(dev):
    tree, meta = image_variables(seed=3, image_size=64)
    imgs = np.random.RandomState(4).randint(0, 256, (5, 64, 64, 3),
                                            np.uint8)
    for dtype in ('float32', 'bfloat16'):
        cuda_engine = EmotionEngine(image_variables=tree, image_meta=meta,
                                    compute_dtype=dtype, device='cuda')
        cpu_meta = dict(meta)
        if dtype == 'bfloat16':
            scales = extract_static_scales(cuda_engine.image['variables'])
            cpu_meta['int8_scales'] = {
                cuda_engine._image_scales_key(): scales}
        cpu_engine = EmotionEngine(image_variables=tree, image_meta=cpu_meta,
                                   compute_dtype=dtype, device='cpu')
        got = cuda_engine.predict_images(imgs, want_features=True)
        ref = cpu_engine.predict_images(imgs, want_features=True)
        band = 1e-4 if dtype == 'float32' else 2e-2
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g['all_probabilities'],
                                       r['all_probabilities'], atol=band)
            p = np.sort(r['all_probabilities'])
            if p[-1] - p[-2] > band:
                assert g['emotion'] == r['emotion']
        if dtype == 'float32':
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g['_features'], r['_features'],
                                           atol=1e-4)


def _noise_frames(shape_bt, dev, seed=0):
    """Hann-windowed center frames of 0.1-scale noise: (B, T, 2048),
    cut from as many 130-frame clips as B * T frames need."""
    B, T = shape_bt
    clips = -(-B * T // 130)
    y = np.random.RandomState(seed).randn(clips, N).astype(np.float32) * 0.1
    frames = af.frame_signal(torch.from_numpy(y).to(dev), edge=False)
    frames = (frames * af._consts(dev)['hann']).reshape(-1, 2048)
    return frames[:B * T].reshape(B, T, 2048).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['highest', 'bf16'])
@pytest.mark.parametrize('bt', [(1, 130), (32, 130), (3, 7), (1, 1),
                                (1, 131)])
def test_dft_spectrograms_kernel(dev, bt, precision):
    frames = _noise_frames(bt, dev, seed=bt[0])
    before = dft_kernel.dft_spectrograms.launches
    km, kp = dft_kernel.dft_spectrograms(frames, precision)
    pm, pp = dft_kernel.dft_spectrograms_plain(frames, precision)
    torch.cuda.synchronize()
    assert dft_kernel.dft_spectrograms.launches == before + 1
    assert km.shape == kp.shape == bt + (1025,)
    assert (km - pm).abs().max().item() <= 5e-5
    assert ((kp - pp).abs() / (pp + 1e-6)).max().item() < 5e-3
    # the Nyquist bin is computed beside the tiles, and the last rows of
    # a ragged row tile (131 = 4 * 32 + 3; 4160 = 32 * 128 + 64) are real
    assert (km[..., -1] - pm[..., -1]).abs().max().item() <= 5e-5
    assert (km[:, -1] - pm[:, -1]).abs().max().item() <= 5e-5


@pytest.mark.cuda
def test_trimodal_engine_on_cuda_matches_cpu(dev, monkeypatch):
    """A narrow tri-modal engine (2-layer BERT, 64 px ResNet50) on the
    card and on the CPU: fp32 within 1e-4; bf16 int8-static at
    MEC_DFT_PRECISION=highest (K5 on the path) within the 2e-2 band."""
    rng = np.random.RandomState(5)
    waves = _waves(3, seed=5)
    imgs = rng.randint(0, 256, (3, 64, 64, 3), np.uint8)
    texts = ['i am so happy today', 'this is sad', 'wow']
    kw = dict(vocab_size=200, hidden_size=64, num_layers=2,
              intermediate_size=128, max_position=128)
    tree, meta = image_variables(seed=3, image_size=64)
    trees = dict(image_variables=tree, bert_variables=bert_variables(1, **kw),
                 bert_kwargs=dict(kw, num_heads=2), bert_vocab=make_vocab(),
                 fusion_variables=fusion_variables(2, text_dim=64),
                 fusion_config={'text_dim': 64})
    speech = speech_variables(seed=1)
    monkeypatch.setattr(Config, 'DFT_PRECISION', 'highest')
    for dtype, band in (('float32', 1e-4), ('bfloat16', 2e-2)):
        cuda_engine = EmotionEngine(speech, None, image_meta=meta,
                                    compute_dtype=dtype, device='cuda',
                                    **trees)
        img_meta, bert_meta = dict(meta), {}
        if dtype == 'bfloat16':
            assert cuda_engine._dft_precision == 'highest'
            img_meta['int8_scales'] = {cuda_engine._image_scales_key():
                                       extract_static_scales(
                                           cuda_engine.image['variables'])}
            bert_meta['int8_scales'] = {cuda_engine._bert_scales_key():
                                        extract_static_scales(
                                            cuda_engine.bert['variables'])}
        cpu_engine = EmotionEngine(speech, None, image_meta=img_meta,
                                   compute_dtype=dtype, device='cpu',
                                   **dict(trees, bert_meta=bert_meta))
        before = dft_kernel.dft_spectrograms.launches
        got = cuda_engine._run_trimodal(waves, texts, imgs)
        launched = dft_kernel.dft_spectrograms.launches - before
        assert launched == (1 if dtype == 'bfloat16' else 0)
        ref = cpu_engine._run_trimodal(waves, texts, imgs)
        assert got.shape == (3, 34) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=band)
        for g, r in zip(got, ref):
            for lo in (0, 7, 14, 21):
                p = np.sort(r[lo:lo + 7])
                if p[-1] - p[-2] > band:
                    assert np.argmax(g[lo:lo + 7]) == np.argmax(r[lo:lo + 7])


@pytest.mark.cuda
def test_forest_walk_on_cuda_matches_cpu(dev):
    arrays, meta = forest_arrays(seed=2)          # 100 trees, depth 12
    x = np.random.RandomState(3).dirichlet(np.ones(7), (33, 3)).reshape(
        33, 21).astype(np.float32)
    out = {}
    for d in ('cpu', dev):
        t = forest_from_jax(arrays, d)
        xt = torch.from_numpy(x).to(d)
        out[str(d)] = (forest_leaves(t, xt, meta['depth']).cpu(),
                       forest_apply(t, xt, meta['depth']).cpu())
    (lc, pc), (lk, pk) = out['cpu'], out[str(dev)]
    assert torch.equal(lc, lk)
    assert (pc - pk).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize('size', [32, 224])
def test_mobilenet_on_cuda_matches_cpu(dev, size):
    tree, _ = mobilenet_variables(seed=1, image_size=size)
    x = torch.from_numpy(np.random.RandomState(size).randn(
        4, size, size, 3).astype(np.float32))
    out = []
    for d in ('cpu', dev):
        model = MobileNetV2EmotionModel()
        model.load_state_dict(mobilenet_state_from_jax(tree))
        with torch.inference_mode():
            out.append([t.cpu() for t in model.to(d).eval()(x.to(d))])
    for a, b in zip(*out):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_models_dir_on_cuda_matches_cpu(dev, tmp_path, monkeypatch):
    d = write_synthetic_artifacts(str(tmp_path), tiny=True,
                                  image_arch='mobilenet_v2', image_size=64)
    monkeypatch.setattr(Config, 'FUSION_MODE', 'rf')
    waves = _waves(3, seed=4)
    imgs = np.random.RandomState(6).randint(0, 256, (3, 64, 64, 3),
                                            np.uint8)
    texts = ['i am so happy today', 'this is sad', 'wow']
    # bf16: chip_smoke.py's MOBILENET_BAND (tests/test_quant.py's band for
    # MobileNetV2 in int8 against fp32)
    for dtype, band in (('float32', 1e-4), ('bfloat16', 5e-2)):
        cuda_engine = EmotionEngine.from_models_dir(d, compute_dtype=dtype)
        assert cuda_engine.device.type == 'cuda'
        assert cuda_engine._fusion_kind == 'rf'
        cpu_engine = EmotionEngine.from_models_dir(d, compute_dtype=dtype,
                                                   device='cpu')
        if dtype == 'bfloat16':
            assert cpu_engine._image_scales_cached
            assert cpu_engine._bert_scales_cached
        before = speech_kernels.speech_dnn.launches
        got = cuda_engine._run_trimodal(waves, texts, imgs)
        assert speech_kernels.speech_dnn.launches == before + (
            dtype == 'bfloat16')
        ref = cpu_engine._run_trimodal(waves, texts, imgs)
        assert got.shape == (3, 28) and np.isfinite(got).all()
        np.testing.assert_allclose(got[:, :21], ref[:, :21], atol=band)
        xt = torch.from_numpy(np.ascontiguousarray(got[:, :21])).to(dev)
        own = forest_apply(cuda_engine.forest['arrays'], xt,
                           cuda_engine.forest['depth']).cpu().numpy()
        np.testing.assert_allclose(got[:, 21:], own, atol=1e-6, rtol=0)
        # rows whose walks park at the same leaves on both devices' s/t/i
        # (a walk within the band of a threshold may flip) agree in fp32
        arrays = cuda_engine.forest['arrays']
        leaves = [forest_leaves(arrays, torch.from_numpy(
            np.ascontiguousarray(r[:, :21])).to(dev),
            cuda_engine.forest['depth']) for r in (got, ref)]
        rows = (leaves[0] == leaves[1]).all(1).cpu().numpy()
        if dtype == 'float32':
            assert rows.any()
            np.testing.assert_allclose(got[rows, 21:], ref[rows, 21:],
                                       atol=1e-6, rtol=0)
