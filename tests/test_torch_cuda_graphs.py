"""The tri-modal step's CUDA graphs (mec_tpu_torch/serving/graphs.py) on
the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file
imports no jax, so it runs on the card's machine (which has none):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py -q

Two bf16 engines, one for each benchmark configuration's kind, at its
widths but for BERT's depth (two layers of BERT-base; depth changes no
kernel): attention fusion on the device frontend with ResNet50 at 224 px
(K1-K4, K6, K7), and the forest on host audio features with MobileNetV2
at 224 px (K4); and the first one's fp32 parity engine (the rFFT
frontend, K2 alone). Each warms buckets 1, 8 and 32, which captures nine
graphs. Contracts: a replay equals the eager step bit for bit at every
captured shape; two threads replaying one graph at once each get their
own rows; an uncaptured shape runs eagerly and opens no step.replay; a
replay advances each kernel wrapper's .launches by the calls its capture
made, which are the calls of one eager step.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import (dft_kernel, pool_kernel, resnet_kernel,
                               rolloff_kernel, speech_kernels, tuning_kernel)
from mec_tpu_torch.serving.engine import EmotionEngine
from mec_tpu_torch.serving.synthetic_artifacts import (
    bert_variables, forest_arrays, fusion_variables, image_variables,
    make_vocab, mobilenet_variables, speech_variables)
from mec_tpu_torch.utils.profiling import timer

STEP = '_trimodal_forward'
BUCKETS = (1, 8, 32)
SEQS = (16, 32, 128)
WRAPPERS = {'mfcc_mean': speech_kernels.mfcc_mean,
            'tuning_select': tuning_kernel.tuning_select,
            'rolloff_bins': rolloff_kernel.rolloff_bins,
            'speech_dnn': speech_kernels.speech_dnn,
            'dft_spectrograms': dft_kernel.dft_spectrograms,
            'max_pool_3x3s2': pool_kernel.max_pool_3x3s2,
            'layer1': resnet_kernel.layer1}
# the wrappers one step calls, by engine kind
CALLS = {'attention': {'mfcc_mean': 1, 'tuning_select': 1,
                       'rolloff_bins': 1, 'speech_dnn': 1,
                       'max_pool_3x3s2': 1, 'layer1': 1},
         'rf': {'speech_dnn': 1},
         'parity': {'tuning_select': 1}}
BERT = dict(hidden_size=768, num_layers=2, intermediate_size=3072)


@pytest.fixture(scope='module', params=['attention', 'rf', 'parity'])
def engine(request):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: CUDA graphs are captured only '
                    'there')
    kind = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Config, 'FUSION_MODE',
                   'rf' if kind == 'rf' else 'attention')
        mp.setattr(Config, 'HOST_AUDIO_FEATURES',
                   '1' if kind == 'rf' else '0')
        mp.setattr(Config, 'DFT_PRECISION', 'high')
        image, meta = (image_variables(seed=3) if kind == 'attention'
                       else mobilenet_variables(seed=3))
        forest = {}
        if kind == 'rf':
            arrays, fmeta = forest_arrays(seed=2)
            forest = dict(forest_arrays=arrays, forest_meta=fmeta)
        eng = EmotionEngine(
            speech_variables(seed=1), None, image_variables=image,
            image_meta=meta, bert_variables=bert_variables(1, **BERT),
            bert_kwargs=dict(BERT, num_heads=12), bert_vocab=make_vocab(),
            fusion_variables=fusion_variables(2),
            compute_dtype='float32' if kind == 'parity' else 'bfloat16',
            device='cuda', **forest)
        assert eng._fusion_kind == ('rf' if kind == 'rf' else 'attention')
        assert eng._host_audio == (kind == 'rf')
        assert (eng._dft_precision == 'parity') == (kind == 'parity')
        eng.warmup(BUCKETS)
    return kind, eng


def _args(eng, b, s, seed):
    """The tri-modal step's host arguments for b rows of sequence width
    s: noise clips, random token ids with random lengths, noise photos."""
    rng = np.random.RandomState(seed)
    waves = (0.1 * rng.randn(b, af.N_SAMPLES)).astype(np.float32)
    ids = rng.randint(5, 1000, (b, s)).astype(np.int32)
    mask = (np.arange(s)[None] < rng.randint(1, s + 1, (b, 1))).astype(
        np.int32)
    imgs = rng.randint(0, 256, (b,) + eng._image_size + (3,), np.uint8)
    return eng._wire_waves(waves, b), ids, mask, eng._wire_image(imgs, b)


def _eager(eng, args):
    (x,) = eng._blocks(args)
    return eng._trimodal_forward(*x).cpu().numpy()


def _replays():
    return timer.totals().get('step.replay', {}).get('count', 0)


@pytest.mark.cuda
def test_warmup_captures_every_bucket_and_sequence_bucket(engine):
    _kind, eng = engine
    keys = list(eng._graphs._graphs)
    seqs = {k[1][1][0][1] for k in keys}      # ids: ((rows, seq), dtype)
    rows = {k[1][1][0][0] for k in keys}
    assert len(keys) == len(BUCKETS) * len(SEQS)
    assert {k[0] for k in keys} == {STEP}
    assert seqs == set(SEQS) and rows == set(BUCKETS)


@pytest.mark.cuda
@pytest.mark.parametrize('b', BUCKETS)
@pytest.mark.parametrize('s', SEQS)
def test_replay_equals_the_eager_step_bit_for_bit(engine, b, s):
    _kind, eng = engine
    args = _args(eng, b, s, seed=100 * b + s)
    want = _eager(eng, args)
    n = _replays()
    got = eng._run(STEP, *args)
    assert _replays() == n + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_two_threads_replaying_one_graph_get_their_own_rows(engine):
    """The interpreter switches threads every 10 us here (5 ms by
    default), so the two threads' copies, replays and clones would
    interleave without the graph's lock."""
    _kind, eng = engine
    args = [_args(eng, 8, 32, seed) for seed in (11, 12)]
    want = [_eager(eng, a) for a in args]
    assert not np.array_equal(want[0], want[1])
    got = {0: [], 1: []}
    start = threading.Barrier(2)

    def work(i):
        start.wait()
        for _ in range(60):
            got[i].append(eng._run(STEP, *args[i]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    for i in (0, 1):
        assert len(got[i]) == 60
        for rows in got[i]:
            np.testing.assert_array_equal(rows, want[i])


@pytest.mark.cuda
@pytest.mark.parametrize('b,s', [(3, 16), (8, 64)])
def test_an_uncaptured_shape_runs_eagerly(engine, b, s):
    _kind, eng = engine
    args = _args(eng, b, s, seed=7)
    assert eng._graphs.get(STEP, eng._blocks(args)[0]) is None
    n = _replays()
    text = timer.totals().get('step.launch.text', {}).get('count', 0)
    got = eng._run(STEP, *args)
    assert _replays() == n
    assert timer.totals()['step.launch.text']['count'] == text + 1
    np.testing.assert_array_equal(got, _eager(eng, args))


@pytest.mark.cuda
def test_a_replay_counts_the_captured_kernel_calls(engine):
    kind, eng = engine
    args = _args(eng, 8, 16, seed=3)
    g = eng._graphs.get(STEP, eng._blocks(args)[0])
    assert {w.__name__: n for w, n in g.calls.items()} == CALLS[kind]
    before = {n: w.launches for n, w in WRAPPERS.items()}
    eng._run(STEP, *args)
    replayed = {n: w.launches - before[n] for n, w in WRAPPERS.items()}
    before = {n: w.launches for n, w in WRAPPERS.items()}
    _eager(eng, args)
    eager = {n: w.launches - before[n] for n, w in WRAPPERS.items()}
    assert replayed == eager
    assert replayed == {n: CALLS[kind].get(n, 0) for n in WRAPPERS}
