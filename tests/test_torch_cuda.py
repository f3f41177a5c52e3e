"""The CUDA kernels of mec_tpu_torch against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file
imports no jax, so it runs on the card's machine (which has none):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures jax.) Inputs are the serving
path's shapes at B=1 and B=32, made from a numpy seed. Tolerances, each
with its reason: K1 |k - p| <= 1e-4 + 2e-6|p| (summation order and
log10f's last bit; MFCC0 reaches -1131, where one f32 ulp is 1.2e-4);
K2 bit-exact (integer and compare work only); K3 equal bins except
one-bin steps where the f64 prefix is within the worst-case f32 sum
rounding (1025 * 2**-24 of the total) of the threshold; K4 probs
2e-6 and penult 2e-5 (the JAX kernel test's bounds).
"""

import numpy as np
import pytest
import torch

from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import rolloff_kernel, speech_kernels, tuning_kernel
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import speech_variables

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
@pytest.mark.parametrize('B', [1, 32])
def test_mfcc_mean_kernel(dev, B):
    _mag, P = _spectra(B, dev)
    before = speech_kernels.mfcc_mean.launches
    k = speech_kernels.mfcc_mean(P)
    p = speech_kernels.mfcc_mean_plain(P)
    torch.cuda.synchronize()
    assert speech_kernels.mfcc_mean.launches == before + 1
    assert bool(((k - p).abs() <= 1e-4 + 2e-6 * p.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 32])
def test_tuning_select_kernel(dev, B):
    _mag, P = _spectra(B, dev)
    mags, pitches = af.tuning_candidates(P)
    residual = af.fold_residual(pitches)
    kb, kh = tuning_kernel.tuning_select(mags, residual, pitches)
    pb, ph = tuning_kernel.tuning_select_plain(mags, residual, pitches)
    assert torch.equal(kb, pb) and torch.equal(kh, ph)


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 32])
def test_rolloff_bins_kernel(dev, B):
    mag, _P = _spectra(B, dev)
    rows = torch.cat([mag.reshape(-1, 1025),
                      torch.zeros(1, 1025, device=dev)])
    k = rolloff_kernel.rolloff_bins(rows)
    p = rolloff_kernel.rolloff_bins_plain(rows)
    assert k[-1].item() == 0
    for r in torch.nonzero(k != p).flatten().tolist():
        cum = torch.cumsum(rows[r].double(), 0)
        lo = min(k[r].item(), p[r].item())
        assert abs(k[r].item() - p[r].item()) == 1
        assert abs(cum[lo].item() - 0.85 * cum[-1].item()) \
            <= 1025 * 2.0 ** -24 * cum[-1].item()   # f32 sum rounding


@pytest.mark.cuda
@pytest.mark.parametrize('B', [1, 32])
def test_speech_dnn_kernel(dev, B):
    x = torch.from_numpy(np.random.RandomState(B).randn(B, 56)
                         .astype(np.float32)).to(dev)
    fwd = speech_kernels.make_speech_dnn(speech_variables(), dev)
    k = fwd(x)
    p = speech_kernels.speech_dnn_plain(x, fwd.params, fwd.dims)
    torch.cuda.synchronize()
    assert (k[:, :7] - p[:, :7]).abs().max().item() <= 2e-6
    assert (k[:, 7:] - p[:, 7:]).abs().max().item() <= 2e-5
    assert bool((k[:, 71:] == 0).all())


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
def test_engine_on_cuda_matches_cpu(dev):
    waves = _waves(5, seed=3)
    tree = speech_variables(seed=1)
    feats = af.audio_features_56(torch.from_numpy(_waves(32))).numpy()
    scaler = (feats.mean(axis=0), feats.std(axis=0) + 1e-3)   # standardize
    cuda_engine = EmotionEngine(tree, scaler, device='cuda')
    cpu_engine = EmotionEngine(tree, scaler, device='cpu')
    got = cuda_engine.predict_speech_waves(waves, want_features=True)
    ref = cpu_engine.predict_speech_waves(waves, want_features=True)
    for g, r in zip(got, ref):
        assert g['emotion'] == r['emotion']
        np.testing.assert_allclose(g['all_probabilities'],
                                   r['all_probabilities'], atol=1e-4)
        np.testing.assert_allclose(g['_features'], r['_features'], atol=1e-4)
