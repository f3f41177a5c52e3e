#!/usr/bin/env python3
"""Smoke test of mec_tpu_torch's serving and training paths on one
NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Five paths are driven: speech (waveform -> wire -> 56-dim frontend ->
SpeechDNN; kernels K1-K4), image (uint8 RGB -> YUV 4:2:0 wire ->
full-width 224 px ResNet50 in bf16 with BN folded and int8 static
convs; kernels K6 stem pool, K7 layer1), the tri-modal request (the
two, BERT-base in bf16 with int8 static encoder matmuls and the
attention fusion in one device step; with MEC_DFT_PRECISION=highest the
speech frontend is the framed one on kernel K5), and a models directory
served through get_engine and the inference facades (MobileNetV2 at
224 px and the random-forest fusion; K1-K4), and a models directory
whose BERT is a mixture of experts served in the tri-modal step (K1-K4,
K6, K7); and training: the six trainers on the card, and the directory
they write served (K2 in the speech trainer's dataset load; K1-K4, K6,
K7 serving it), the MoE BERT trainer, and data-parallel training over
torch.distributed (two gloo ranks sharing the card, one NCCL rank);
serving data parallelism (two replicas of the models sharing the card,
K1-K4, K6, K7 on each) and the BERT trainer's tensor, sequence, expert
and pipeline parallelism (two gloo ranks sharing the card); and the
system's entry point: a reference-format models directory (.pt, HF
BERT) converted at load and served over HTTP by the port's web app and
its serve CLI (K1-K4, K6, K7 once a tri-modal request's dispatch);
and the native host runtime: the C++ wire encoders, WordPiece encoder
and audio featurizer built with g++ from the checkout, and speech and
tri-modal engines with MEC_HOST_AUDIO_FEATURES=1, whose wire is the
host's 56 features (K4, and K6, K7 tri-modal; K1-K3, K5 never). Every
phase before 6g runs with MEC_HOST_AUDIO_FEATURES=0 (the waveform
wire), set before the port is imported.

Phases (the first failure exits non-zero; no phase's failure is caught):
  1. device   require a CUDA device; print nvidia-smi's name, power.limit
  2. build    build the CUDA kernels from mec_tpu_torch/csrc (one nvcc
              per source, in parallel, sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card,
              at the serving path's shapes for B=32 and B=1 (the four
              speech kernels K1-K4 also at B=8 and B=33: the middle
              bucket, and a ragged last cluster, tile or block; K1 and K2
              twice, bit-identical): K1-K4 on seeded tones, chirps, noise
              and one silent clip, K2 also on a noise-only batch (many
              candidates) and on the silent clip alone (none); K5 on
              Hann-windowed frames of 0.1-scale noise in both
              precisions; K6 and K7 on the stem output of seeded images
              through the image engine's own model
  4. engine   speech: full-width speech DNN from a numpy seed (Flax
              layout, serving/synthetic_artifacts.py). A bf16 serving
              engine (pcm12 wire, MEC_DFT_PRECISION=high) warms up
              buckets (1, 8, 32), predicts B=1, 5, 32 and serves 4 WAV
              files through the micro-batcher; checks results, the
              launch counters (each of K1-K4 once per dispatch, the
              others never) and agreement with the same engine on
              device='cpu' within SPEECH_BAND. Beside it an fp32 parity
              engine (float32 wire, rFFT frontend, cumsum rolloff,
              live-BN SpeechDNN): K2 once per dispatch and K1, K3, K4
              never, agreement with device='cpu' within 1e-4, and with
              the plain model on the parity features
  5. image    full-width ResNet50 (224 px) from a numpy seed; a bf16
              int8-static engine calibrates on the card, warms up buckets
              (1, 8, 32), predicts B=1, 5, 32 and, if PIL is present,
              serves 4 PNGs through the micro-batcher; checks results,
              the launch counters (K6 and K7 once per dispatch, the
              others never), agreement with the same engine on
              device='cpu' (given the card's scales) and an fp32 parity
              engine on the card against device='cpu' within 1e-4
  6. trimodal full-width speech DNN, BERT-base (12 layers, hidden 768,
              vocab 30522), ResNet50 and fusion net from numpy seeds; a
              bf16 engine (pcm12 and YUV wires, int8 static BERT and
              image) built at MEC_DFT_PRECISION=high and again at
              highest: each warms up every batch and sequence bucket,
              serves 4 requests (WAV + text + PNG) one at a time and 4
              through the micro-batcher; checks the launch counters (K1-K4,
              K6, K7 once per tri-modal dispatch in both engines, K5 only
              in the highest one), agreement of all 34 packed values with
              the same engine on device='cpu' (given the card's scales)
              and an fp32 parity tri-modal engine against device='cpu'
              within 1e-4
  6a. train   (a) the accuracy gates of the JAX end-to-end fixture
              (tests/test_end_to_end.py:94-149) on the port's corpora
              (training/corpora.py), each trainer on the card: speech
              from a wav tree (12 epochs, > 0.85; its dataset load must
              launch K2 once a chunk of 256 clips and K1, K3, K4 never),
              Bi-LSTM (max_length 16, 8 epochs, > 0.40), tiny BERT
              (hidden 64, 2 layers, 8 epochs, > 0.85), MobileNetV2 at 48
              px (24 epochs, phase1_epochs 2, lr 1e-3, > 0.5), fusion
              (600 rows, 6 epochs: its > 0.55 holds for the JAX
              trainer's seed-42 stream only, so the mean over seeds
              10-15 must reach the JAX trainer's mean there less three
              standard errors, training/corpora.py; seed 42 is printed
              beside 0.55); (b) full width, a few
              optimizer steps each through the trainers' own steps and
              optimizers: ms/step (median of CUDA-event steps after
              warm-up), samples/s, peak device memory (and for BERT-base
              fp32 and bf16 and ResNet50 phase 2 a profiled window: busy
              share, device ops a step) for the speech
              DNN B=64, the Bi-LSTM (vocab 10000, seq 128, B=32),
              BERT-base B=16 seq 128 in fp32, bf16 (autocast) and fp32
              with grad-accum 2 and remat, ResNet50 224 px B=32 (phase
              1 and 2 in fp32, phase 2 in bf16), MobileNetV2 224 px B=32
              and the fusion net B=64; the CLI once as a subprocess
              (python -m mec_tpu_torch train-speech --epochs 1); (c) the
              trained full-width speech DNN and Bi-LSTM of (a) and
              BERT-base, ResNet50 and fusion net of (b) written to one
              models directory, served by get_engine in bf16: K1-K4, K6,
              K7 once per tri-modal dispatch, tri-modal and
              predict_texts_lstm results within the bands of the cpu
              engine on the same directory, the Bi-LSTM in fp32 within
              1e-4
  6b. models  the port's writer makes a full-width models directory (speech
              DNN, BERT-base with config.json and vocab.txt, MobileNetV2 at
              224 px, the fusion net, a 100-tree depth-12 forest over 21
              features); get_engine(dir) with MEC_FUSION_MODE=rf and bf16
              lands on the card, calibrates and writes its int8 scales
              back into the .mecp metas; warms up buckets (1, 8, 32),
              serves 4 requests through MultimodalFusion().predict_
              multimodal and 4 through the micro-batcher, one image and
              one text through ImageInference and TextInference; checks
              28-wide rows with method 'random_forest', the launch
              counters (K1-K4 once per dispatch, K5-K7 never), agreement
              with from_models_dir(device='cpu') (which must take the
              card's scales from the cache) at B <= 5: speech, text and
              image within their bands, the rf tail within 1e-6 of the
              forest on the card's own s/t/i and equal to the cpu's
              wherever no walk compares an input within those bands of
              its threshold (near walks counted); and a second card
              engine in fp32 against the cpu within 1e-4
  6c. moe     a full-width mixture-of-experts directory from the port's
              writer (BERT-base widths, 12 layers, E=4, capacity 1.25,
              config.json with num_experts; ResNet50 224 px); get_engine
              serves it in bf16 (int8 static attention, bf16 experts)
              on the card: warmup of buckets (1, 8, 32) and the tri-modal
              step at B=1, 8, 32 x seq 16, 32, 128, checking K1-K4, K6,
              K7 once per dispatch and K5 never; agreement with
              from_models_dir(device='cpu') (the card's scales from the
              cache) at B=8 for each sequence bucket within
              MOE_TRI_BAND, with the tokens routed to another expert
              than on the cpu counted (moe_routes); an fp32 card engine
              against the cpu within 1e-4 (flips printed); CUDA-event
              times of the MoE tri-modal and text steps and profiled
              windows (busy share, ops) at b1 seq 16 and b32 seq 128
              (the two other shapes cut, PR 21, to make room for 6h);
              the MoE BERT-base train step (B=16, seq
              128, fp32: ms/step, samples/s, peak memory, a profiled
              window); the tiny BERT gate trained with --experts 2
  6d. dp      two gloo ranks sharing the card (parallel.launch): the
              float64 gradients of the fusion net, the speech DNN
              (BatchNorm statistics over both ranks) and a tiny MoE BERT
              (the global aux loss) after the all-reduce against one
              process on the same global batch within DP_TOL; a 3-epoch
              fusion fit, identical on both ranks and within 1e-3 of one
              process; the all-reduce time of 64 MiB; one NCCL rank
              initialized by initialize_multi_host from the MEC_*
              variables (the gradient all-reduce a multi-GPU machine
              runs); python -m mec_tpu_torch train-fusion --mesh-data 2
              must refuse on one card, naming the visible GPU count
  6e. dp2     serving data parallelism: a full-width directory (BERT-base,
              ResNet50 224 px, attention fusion, a fitted speech scaler)
              served by get_engine(dir, mesh=['cuda:0', 'cuda:0']) in bf16,
              tri-modal requests at B=1, 8, 32 through
              predict_multimodal_batch: K1-K4, K6, K7 launched once a
              replica a dispatch, K5 never; each replica's rows bit for
              bit a single-replica engine's on the same rows at the same
              per-replica bucket, the whole within
              dp_scaling.SERVE_DP_BAND (0.02) of mesh=None, the scales
              the single engine's; fp32 within 1e-5; host walls at B=1,
              32 with one and two replicas. The BERT trainer's model and
              pipe axes: two gloo ranks sharing
              the card at BERT-base widths, seq 128, B=8, float64, for
              TP=2, TP=2 with SP, EP (E=4 over 2) and PP=2 (M=2): loss,
              clip norm and gradients after the reduce, gathered to the
              whole tree, against one process within 1e-10 of the
              largest gradient; train-text-bert --mesh-model 2 must
              refuse on one card, naming the visible GPU count
  6f. entry   the host packages (find_spec of jinja2, werkzeug, h5py,
              sklearn, joblib, safetensors); a full-width directory in the
              reference's formats written from the seeds of phase 6
              (ResNet50 image_model.pt and fusion_model.pt in the
              reference's key names, HF BERT-base bert_model/ with
              pytorch_model.bin and model.safetensors, config.json,
              vocab.txt; the speech DNN as a Keras .h5 with a sklearn
              scaler .pkl where h5py and sklearn are present, else its
              .mecp and .npz, and then convert_speech_h5 must raise an
              ImportError naming h5py); get_engine(dir) in bf16 on the
              card converts, writes each .mecp beside its artifact
              (leaf for leaf the seed trees), calibrates and warms up
              (1, 8, 32); a second from_models_dir with every converter
              replaced by one that fails reads the caches, and its
              tri-modal rows at B=1, 8 are the first engine's bit for
              bit; the directory on device='cpu' within TRI_BAND; both
              load walls printed. The port's create_app on werkzeug's
              make_server in a thread (temporary sqlite database):
              /api/register, then over urllib the four prediction routes
              (each equal to the engine's own result within TRI_BAND),
              8 concurrent tri-modal requests from 8 threads, 20
              sequential b1 tri-modal requests (first, p50 and p99 host
              walls printed), /api/predictions one row a request, and
              the launch counters: K1-K4, K6, K7 once a tri-modal
              dispatch, K5 never. python -m mec_tpu_torch serve
              --device cuda --warmup as a subprocess answers one
              tri-modal request and must end by the SIGTERM sent. A
              bf16 speech engine under MEC_USE_PALLAS=0 (K2 alone), and
              MEC_PALLAS_TUNING=0 and MEC_PALLAS_ROLLOFF=0 (K2 or K3
              off), each within SPEECH_BAND of the cpu; a fresh
              interpreter reads a .env in its working directory
  6g. host    native.status() (wirecodec, wordpiece, audiofeat built by
              g++ from mec_tpu_torch/native/*.cpp; all three must load)
              and what MEC_HOST_AUDIO_FEATURES=auto resolves to on this
              host; at B=32 full width: encode_pcm12 native bytes equal
              to numpy, encode_yuv420 Y equal and UV within one code,
              WordPiece ids and mask (32 texts, max_length 128) equal to
              Python, extract56 within the original's contract of
              features_56_np on the contract's six clips and in MFCC and
              the spectral scalars on 32 seeded clips (chroma rows past
              1e-3 counted: tuning near-ties); a bf16 speech engine and
              the full-width tri-modal engine of phase 6 (its trees and
              card scales) with MEC_HOST_AUDIO_FEATURES=1, warmed up (1,
              8, 32) and predicting B=1, 5, 32 (and one request from its
              files): K4 once a dispatch, K6 and K7 once a tri-modal
              dispatch, K1-K3 and K5 never; agreement with the same
              engines on device='cpu' within SPEECH_BAND and TRI_BAND;
              preprocess_audio on a WAV on the card (K2 once, within
              1e-4 + 2e-6|c| of device='cpu'); host times in turns:
              the encoders native against numpy at B=1, 32, WordPiece
              native against Python, extract56 against features_56_np
              at B=1, 8, 32 beside the bf16 speech device step of each
              wire, and predict_multimodal b1 (p50 of 20) and
              predict_multimodal_batch b32 (p50 of 10) with the
              waveform wire and with host features; the host's CPU model
              and count
  6h. moonlight  Moonlight-16B-A3B's text leg at its published widths
              (15.6 B bf16 parameters drawn on the card by the
              benchmark's leg, benchmark/configs/
              moonlight16b_resnet50_attn.json) in a tri-modal engine with
              phase 6's speech and image trees and a fusion net at
              text_dim 2048: the grouped expert GEMM against its plain
              version at b1 x 16, 32, 128 and b32 x 128 on layer 1's
              experts within EXPERT_TOL, a dropped K-slice of down and a
              tile shifted by a row each reading above it, and one
              layer's CUDA-event ms beside its plain version's; warmup
              captures the nine shapes; with the kernel's count zeroed,
              b1 requests at sequence buckets 16, 32, 128 and a b32 x 128
              dispatch: 26 calls (52 launches) a dispatch, and a profiled
              window of each: the kernel's device ms a dispatch, the
              card's busy ms, and the bound of benchmark/bounds/
              grouped_expert_gemm.py at the routing the program recorded
              (text.moe.experts_touched, text.moe.routed_pairs). The
              expert layer's glue kernels (csrc/expert_routing.cu: the
              router, the sort, the combine) at the same four shapes on
              layer 1's norm, gate and experts against their plain
              versions (GLUE_NEAR, GLUE_W_TOL; the sort and the combine
              exact) with their CUDA-event ms a call, 26 calls each a
              dispatch in the engine, their device ms a dispatch and the
              dispatch's device launches from the profiled windows
  7. times    CUDA-event medians of each kernel (and, beside it, its
              device time: the summed durations of its device launches
              in a marked torch.profiler range of the same 30 calls,
              which leaves out the wrapper's host work, or "not measured"
              where the profiler lost half of them), its plain version and,
              where one PyTorch call computes the same function, that
              call (K5: one matmul against both bases; K6: F.max_pool2d;
              timed here, used nowhere in the port) at B=32 in turns
              (K5 in both precisions); each kernel's bound from the
              shapes just timed (bytes over the memory rate or
              operations over the peak rate of their unit, H100 SXM
              data sheet); the speech and image device steps at B=1, 8,
              32, the tri-modal device step at B=1, 8, 32 (default and
              highest), the text device step at B=1, 32 and seq 16, 32,
              128, the predict_multimodal host wall at B=1, and one
              profiled window of the tri-modal step (device busy share,
              device ops per step); from the models phase: the MobileNetV2
              image step (bf16 int8, fp32) and the rf tri-modal step (with
              busy share and ops) at B=1, 8, 32, the forest walk and one
              depthwise conv at B=32, and from_models_dir's host wall
  7b. roofline the port's roofline and trace helpers
              (mec_tpu_torch/utils/roofline.py, profiling.device_trace)
              and the engine's batch-1 phase clock: (a) measure_hbm_gbps
              on the card, within RATE_BAND of the data sheet's 3.35
              TB/s; (b) chain_slope_ms of each kernel wrapper at phase 7's
              B=32 shapes (K5 in both precisions), captured into CUDA
              graphs (a wrapper that cannot be captured fails), at least
              CHAIN_FLOOR of phase 7's device_ms; (c) hbm_traffic_bytes of
              the bf16 tri-modal b32 step over phase 7's step time, at
              most TRAFFIC_CAP of (a)'s rate; (d) device_trace around 6
              tri-modal b1 requests of phase 6's engine, whose trace must
              name the __global__ functions of K1-K4, K6 and K7; (e) 20
              predict_multimodal b1 calls, _last_b1_phases' medians
              summing to the median wall within max(1 ms, 15%)
  8. report   the card's name and power limit; a JSON line of the seven
              kernels and, last, the grouped expert GEMM's row from 6h
              (launches, max_abs_err, ms, plain_ms, device_ms, bound_ms
              and share at b32 x 128, by_shape for all four) (name, route, source, replaces, launches and
              launches on the tri-modal paths (launches_by_path: the
              dense engines', the MoE engine's, the two-replica engine's
              of 6e, the HTTP requests' of 6f, the host-feature engines'
              of 6g with their dispatches), launches_per_dispatch,
              serve_dp_launches_per_dispatch, moe_launches_per_dispatch
              and entry_launches_per_dispatch, max_abs_err,
              ms by events, device_ms, plain_ms, bound_ms, bound_by 'bytes' or 'operations',
              bound_peak 'memory', 'fp32', 'bf16_tc' or 'int8_tc',
              library_ms or null, chain_ms (7b); K5's row is the
              'highest' precision and carries the 'bf16' one under bf16_*
              keys); then the contract line last:
              {"ok": true, "device": {"platform": "gpu", ...}}
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N = 66150
REPS = 30
IMAGE_SEED = 6        # a random ResNet50 whose decisions differ on images()
# bf16 serving speech engine on the card against the same engine on the
# CPU: the speech leg is fp32 arithmetic in bf16 mode too (only its wire
# is compressed, and the pcm12 decode is exact on both devices), so the
# two differ by the kernels' and cuBLAS's summation orders alone
# (measured 6.7e-07 on the speech part of the tri-modal rows)
SPEECH_BAND = 1e-4
# bf16 int8 card engine against the same engine on the CPU (given the
# card's static scales): cuDNN and oneDNN accumulate the bf16 stem conv
# and head GEMMs in other orders, so a few activations round one bf16
# step apart and may move an int8 code downstream
IMAGE_BAND = 2e-2
# the bf16 int8-static MobileNetV2 card engine against the same engine
# on the CPU (given the card's static scales): the card's and the CPU's
# bf16 convolutions accumulate in other orders, so where an output rounds
# one bf16 step apart an int8 code downstream may move (`python3 -m
# mec_tpu_torch.bench.kernel_ab --mobilenet-drift` names the stages), as
# quantization moves them against fp32: the band is tests/test_quant.py's
# for MobileNetV2 in int8 against fp32
MOBILENET_BAND = 5e-2
BERT_SEED = 0
FUSION_SEED = 1
# the models directory's trees: a random MobileNetV2 whose decisions differ
# on images()
MODELS_SEED = 1
# bf16 tri-modal card engine against the same engine on the CPU (given
# the card's static scales). Located with `python3 -m
# mec_tpu_torch.bench.kernel_ab --bert-drift` (NVIDIA H100 80GB HBM3,
# 700.00 W against its host's CPU): on identical inputs every int8
# matmul with its quantize and dequantize, the fp32 softmax and the tanh
# GELU of BERT are bit-equal on the two devices; the two LayerNorms (fp32
# mean and variance summed in another order, rounded to bf16: one bf16
# step) and the bf16 attention GEMMs are not. The first difference is at
# the embeddings' LayerNorm; the int8 operands are bit-equal through
# layer 0, 5 of 98,304 codes differ in layer 1 and 27% by layer 11, and
# the synthetic classifier (8x lecun scale, logits up to ~12) turns a CLS
# difference of 0.15 into probability differences of 0.072 to 0.085,
# while each device is up to 0.15 from the fp32 model. No layer is at
# fault, so the band stays above the measured difference
TRI_BAND = 1e-1
# K5 against its plain version: the JAX package's contract for K5
# (tests/test_pallas.py:31-40; 0.1-scale noise frames): mag atol 5e-5,
# P relative 5e-3 over P + 1e-6. It holds for 'bf16' too: kernel and
# plain version sum the same exact fp32 products of bf16-rounded
# operands and differ only in summation order.
K5_MAG_ATOL, K5_P_REL = 5e-5, 5e-3
TEXTS = ['i am so happy today', 'this is terrible and sad',
         'wow what a surprise', 'i feel angry about all of this',
         'the day was calm', 'i hate this awful news', 'really not great',
         'yes i love it and you']


def fail(msg):
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def waves(B, seed):
    """Seeded test clips: silence (row 0), tones, chirps, noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(N) / 22050.0
    rows = [np.zeros(N)]
    for i in range(1, B):
        kind = i % 3
        if kind == 0:
            y = 0.3 * np.sin(2 * np.pi * (150 + 37 * i) * t) \
                + 0.1 * np.sin(2 * np.pi * (310 + 71 * i) * t)
        elif kind == 1:
            y = 0.2 * np.sin(2 * np.pi * (200 + 300 * t * i) * t)
        else:
            y = 0.02 * i * rng.randn(N)
        rows.append(y + 0.01 * rng.randn(N))
    return np.stack(rows).astype(np.float32)


def images(B, seed, size=224):
    """Seeded test images: noise, gradients, flat fields, and some with
    structure (checkerboard, stripes, a disc, a colour ramp)."""
    rng = np.random.RandomState(seed)
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(B):
        kind = i % 8
        if kind == 0:
            img = rng.randint(0, 256, (h, w, 3))
        elif kind == 1:
            img = np.stack([yy / (h - 1) * 255] * 3, -1)
        elif kind == 2:
            img = np.broadcast_to(rng.randint(0, 256, 3), (h, w, 3))
        elif kind == 3:
            img = ((yy // 16 + xx // 16) % 2 * 255)[:, :, None] * np.ones(3)
        elif kind == 4:
            img = np.stack([(np.sin(xx / (3 + i)) + 1) * 127.5] * 3, -1)
        elif kind == 5:
            d = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (h / (3 + i % 3)) ** 2
            img = d[:, :, None] * rng.randint(0, 256, 3)
        elif kind == 6:
            img = np.stack([xx / (w - 1) * 255, yy / (h - 1) * 255,
                            np.full((h, w), 128.0)], -1)
        else:
            img = rng.randint(64 + 8 * (i % 4), 192, (h, w, 3))
        out.append(np.clip(img, 0, 255))
    return np.stack(out).astype(np.uint8)


def check_results(got, ref, band, what):
    """Finite, normalised, no fallback; probabilities within band of ref
    and decisions equal wherever ref's top-2 margin exceeds band.
    Returns the largest probability difference."""
    check(len(got) == len(ref), f'{what}: result count mismatch')
    worst = 0.0
    for g, r in zip(got, ref):
        check(g is not None and '_fallback' not in g, f'{what}: fallback {g}')
        pg = np.asarray(g['all_probabilities'])
        check(bool(np.isfinite(pg).all())
              and abs(pg.sum() - 1.0) <= 1e-5,
              f'{what}: probabilities {pg.tolist()}')
        e = float(np.max(np.abs(pg - np.asarray(r['all_probabilities']))))
        worst = max(worst, e)
        check(e <= band, f'{what}: probs differ from cpu by {e} > {band}')
        top2 = np.sort(r['all_probabilities'])[-2:]
        if top2[1] - top2[0] > band:
            check(g['emotion'] == r['emotion'],
                  f'{what}: decision {g["emotion"]} vs cpu {r["emotion"]}')
    return worst


def serve_through(queue, paths):
    """Submit each path from its own thread; returns the results."""
    served = [None] * len(paths)
    threads = [threading.Thread(
        target=lambda i=i: served.__setitem__(i, queue.submit(paths[i])))
        for i in range(len(paths))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not any(th.is_alive() for th in threads),
          'batcher requests did not finish')
    return served


def cuda_ms(fn, reps=REPS):
    """Median milliseconds of fn() over reps runs, each bracketed by CUDA
    events on the current stream, after 3 warm-up runs."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


PROFILE_MARK = 'chip_smoke.window'


def profiled_launches(fn, reps):
    """The device launches (kernels, and any memset or copy) of reps calls
    of fn(), in the order they started, from one torch.profiler window.
    The profiler loses launches, most often at the edges of a window (the
    first two in most windows on the H100's machine, nearly all of them
    in a few), so the window opens with reps calls and closes with 3
    that are not kept. The kept calls run inside a marked range that is synchronized
    at both ends, and a launch is kept when it starts inside that range:
    the launches before it had ended at its start, the later ones were
    not yet issued at its end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        with record_function(PROFILE_MARK):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    marks = [e for e in events
             if e.name == PROFILE_MARK and e.device_type == DeviceType.CPU]
    if not marks:
        return []
    lo, hi = marks[0].time_range.start, marks[0].time_range.end
    return sorted((e for e in events
                   if e.device_type == DeviceType.CUDA
                   and e.name != PROFILE_MARK
                   and lo <= e.time_range.start <= hi),
                  key=lambda e: e.time_range.start)


def device_ms(fn, reps=REPS, tries=3):
    """Median milliseconds a call of fn() keeps the card busy: the summed
    durations of the device launches of each call inside a profiled range
    of reps calls (profiled_launches), after 3 warm-up calls. Unlike
    cuda_ms it leaves out the wrapper's host work before the launch. A
    range whose launches are not a whole multiple of reps lost some; it
    is profiled again, up to `tries` ranges, and if none is whole the
    time is put together from the fullest by kernel name (the median
    duration of each name times its launches a call), which a few lost
    launches do not move. Where every range lost half its launches or
    more the device time is not measured: returns (None, None), and the
    report says so. Returns (ms, launches a call)."""
    for _ in range(3):
        fn()
    kern = []
    for attempt in range(tries):
        got = profiled_launches(fn, reps)
        if got and len(got) % reps == 0:
            n = len(got) // reps
            per_call = [sum(e.time_range.elapsed_us() for e in got[i:i + n])
                        / 1e3 for i in range(0, len(got), n)]
            return statistics.median(per_call), n
        print(f'profiler: {len(got)} device launches in {reps} calls'
              + (', profiling again' if attempt < tries - 1 else ''))
        kern = max(kern, got, key=len)
    if len(kern) <= reps // 2:
        print(f'profiler: device time not measured ({len(kern)} device '
              f'launches in {reps} calls at best of {tries} ranges)')
        return None, None
    by_name = {}
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    counts = {name: max(1, round(len(d) / reps)) for name, d in by_name.items()}
    print(f'profiler: timing by kernel name from {len(kern)} launches')
    return (sum(counts[name] * statistics.median(d)
                for name, d in by_name.items()), sum(counts.values()))


def fmt_ms(ms, digits=4):
    return 'not measured' if ms is None else f'{ms:.{digits}f} ms'


def profile_step(fn, steps=10):
    """One profiled range of `steps` calls (profiled_launches) after 5
    warm-up calls: the host-clock wall of one synced call (median of 10),
    the device time of its kernels, their share of the wall, kernels per
    call, and the kernels taking the most device time."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    kern = profiled_launches(fn, steps)
    by = {}
    for e in kern:
        by[e.name[:60]] = by.get(e.name[:60], 0.0) \
            + e.time_range.elapsed_us() / steps / 1e3
    busy = sum(by.values())
    wall = statistics.median(walls)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    return wall, busy, busy / wall, len(kern) / steps, top


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved, ops, unit):
    """The least time (ms) the card could take: the larger of the bytes
    moved (each input read once, each output written once) over the
    memory rate and the operations over the peak rate of their unit.
    Returns (ms, 'bytes' or 'operations', the peak that binds): PEAKS of
    mec_tpu_torch/utils/roofline.py, the H100 SXM data sheet's."""
    from mec_tpu_torch.utils.roofline import PEAKS
    t_bytes = moved / PEAKS['memory'] * 1e3
    t_ops = ops / PEAKS[unit] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, 'bytes', 'memory'
    return t_ops, 'operations', unit


# the train phase's accuracy gates: the JAX end-to-end fixture's sizes
# and thresholds (tests/test_end_to_end.py:94-149) on the port's corpora
GATES = {'speech': 0.85, 'lstm': 0.40, 'bert': 0.85, 'image': 0.5,
         'fusion': 0.55}


def step_times(label, card, state, train_step, batch, rows, idle,
               profiled=False, steps=6):
    """Median CUDA-event milliseconds of train_step(state, batch) over
    `steps` calls after 3 warm-up calls, samples/s, the peak device
    memory of those calls above `idle` (what the process held before the
    model was built: the trainer's own parameters, optimizer state and
    activations), and with `profiled` one profiled window (profile_step:
    wall, device busy time and share, device ops a step, the kernel
    taking the most time; ~10 s of host work a window, so only where it
    decides something); printed with the card."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state.model.train()
    for _ in range(3):
        train_step(state, batch)
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(state, batch)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    ms = statistics.median(times)
    peak = (torch.cuda.max_memory_allocated() - idle) / 2 ** 30
    window = ''
    if profiled:
        wall, busy, share, ops, top = profile_step(
            lambda: train_step(state, batch), steps=2)
        # the profiler may lose a window's launches (phase 7's device_ms)
        window = f'; profiled: wall {wall:.3f} ms, ' + (
            f'device busy {busy:.3f} ms, busy share {share:.3f}, '
            f'{ops:.0f} device ops/step, most: {top[0][0]} '
            f'{top[0][1]:.3f} ms' if top else
            'device busy not measured (the window lost its launches)')
    print(f'train step {label}: {ms:.3f} ms/step (median of {steps} CUDA-'
          f'event steps after 3 warm-up), {rows * 1e3 / ms:.1f} samples/s, '
          f'peak memory {peak:.2f} GiB{window}; {card}')
    return ms


def train_phase(card, wrappers, speech_names, requests):
    """6a. train: the accuracy gates, full-width step times, the CLI, and
    the trained directory served on the card against the cpu."""
    import shutil

    import torch

    from mec_tpu_torch.config import Config
    from mec_tpu_torch.convert import store
    from mec_tpu_torch.convert.to_jax import to_jax
    from mec_tpu_torch.models.bert import BertForSequenceClassification
    from mec_tpu_torch.models.bilstm import BiLSTMTextModel
    from mec_tpu_torch.models.fusion import MultiModalFusionModel
    from mec_tpu_torch.models.mobilenet import MobileNetV2EmotionModel
    from mec_tpu_torch.models.resnet import ImageEmotionModel
    from mec_tpu_torch.models.speech_dnn import SpeechDNN
    from mec_tpu_torch.serving.engine import EmotionEngine, get_engine
    from mec_tpu_torch.serving.synthetic_artifacts import make_vocab
    from mec_tpu_torch.training import (common, corpora, train_fusion,
                                        train_image, train_speech,
                                        train_text_bert, train_text_lstm)
    from mec_tpu_torch.training.train_text_bert import WIDTHS
    t_phase = time.perf_counter()
    dev = torch.device('cuda')
    work = tempfile.TemporaryDirectory(prefix='chip_smoke_train_')
    gate_dir = os.path.join(work.name, 'gate_models')

    # a. the accuracy gates
    acc = {}
    speech_root = corpora.make_speech_corpus(
        os.path.join(work.name, 'speech'), per_class=8)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    _v, scaler, hist = train_speech.train(
        data_root=speech_root, epochs=12, batch_size=16,
        models_dir=gate_dir, verbose=False, device='cuda')
    counts = {name: w.launches for name, w in wrappers.items()}
    n_clips = 8 * Config.NUM_EMOTIONS
    chunks = -(-n_clips // 256)
    for name, n in counts.items():
        want = chunks if name == 'tuning_select' else 0
        check(n == want, f'speech dataset load: {name} launched {n} times '
              f'for {chunks} chunk(s) of {n_clips} clips (want {want})')
    acc['speech'] = (max(hist['val_acc']), time.perf_counter() - t0)
    print(f'train speech: {n_clips} wavs loaded through the parity '
          f'frontend on the card in {chunks} chunk(s): launches {counts}')
    texts, labels = corpora.make_text_corpus(per_class=12)
    t0 = time.perf_counter()
    _v, _tok, hist = train_text_lstm.train(
        csv_path=None, texts=texts, labels=labels, epochs=8, batch_size=16,
        max_length=16, models_dir=gate_dir, verbose=False, device='cuda')
    acc['lstm'] = (max(hist['val_acc']), time.perf_counter() - t0)
    tok = corpora.make_bert_tokenizer(texts)
    tiny = dict(vocab_size=len(tok.vocab), hidden_size=64, num_layers=2,
                num_heads=2, intermediate_size=128)
    t0 = time.perf_counter()
    _v, hist = train_text_bert.train(
        csv_path=None, texts=texts, labels=labels, tokenizer=tok, epochs=8,
        batch_size=16, max_length=16, learning_rate=5e-4, model_kwargs=tiny,
        models_dir=os.path.join(gate_dir, 'bert_model'), verbose=False,
        device='cuda')
    acc['bert'] = (max(hist['val_acc']), time.perf_counter() - t0)
    imgs, img_labels = corpora.make_image_corpus(img_size=48, per_class=12)
    t0 = time.perf_counter()
    _v, hist = train_image.train(
        data_root=None, imgs=imgs, labels=img_labels, img_size=48, epochs=24,
        phase1_epochs=2, batch_size=16, learning_rate=1e-3,
        models_dir=gate_dir, verbose=False, arch='mobilenet_v2',
        device='cuda')
    acc['image'] = (max(hist['phase1']['val_acc'] + hist['phase2']['val_acc']),
                    time.perf_counter() - t0)
    dataset = train_fusion.generate_synthetic_data(
        600, dims={'speech': 64, 'text': tiny['hidden_size'], 'image': 512})
    t0 = time.perf_counter()
    fusion_accs = {}
    for seed in (42,) + corpora.FUSION_GATE_SEEDS:
        _v, _cfg, hist = train_fusion.train(
            dataset=dataset, epochs=6, batch_size=64, models_dir=gate_dir,
            verbose=False, device='cuda', seed=seed)
        fusion_accs[seed] = max(hist['val_acc'])
    fusion_secs = time.perf_counter() - t0
    for name, (a, secs) in acc.items():
        print(f'train gate {name:6s}: best val_acc {a:.4f} > {GATES[name]} '
              f'({secs:.1f} s on the card)')
    for name, (a, _s) in acc.items():
        check(a > GATES[name], f'train gate {name}: val_acc {a} <= '
              f'{GATES[name]}')
    # the fixture's fusion threshold is a property of the JAX trainer's
    # seed-42 stream (corpora.JAX_FUSION_BEST_VAL_ACC): the port's
    # trainer is held to the JAX trainer's distribution over seeds
    seeds = corpora.FUSION_GATE_SEEDS
    mean = float(np.mean([fusion_accs[s] for s in seeds]))
    floor = corpora.fusion_gate_floor([fusion_accs[s] for s in seeds])
    print(f'train gate fusion: best val_acc {fusion_accs[42]:.4f} at seed 42 '
          f'(the fixture\'s threshold {GATES["fusion"]}, which the JAX '
          f'trainer meets at its seed-42 stream and at 2 of 20 other seeds; '
          f'not enforced); at seeds {seeds[0]}-{seeds[-1]} '
          + ', '.join(f'{fusion_accs[s]:.4f}' for s in seeds)
          + f': mean {mean:.4f} >= {floor:.4f} (the JAX trainer\'s mean '
          f'{np.mean(corpora.JAX_FUSION_BEST_VAL_ACC):.4f} less 3 standard '
          f'errors) ({fusion_secs:.1f} s on the card for {len(fusion_accs)} '
          f'runs)')
    check(mean >= floor, f'train gate fusion: mean best val_acc {mean} over '
          f'seeds {seeds} < {floor}')

    # b. full width, a few optimizer steps each
    serve_dir = os.path.join(work.name, 'serve_models')
    os.makedirs(os.path.join(serve_dir, 'bert_model'))
    rng = torch.Generator(device='cuda').manual_seed(0)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, device=dev, generator=rng)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=rng)

    def state_of(model, tx):
        return common.TrainState(common.flax_init(model, 0).to(dev), tx)

    def onehot(labels):
        return torch.nn.functional.one_hot(labels, 7).float()

    torch.cuda.empty_cache()
    idle = torch.cuda.memory_allocated()
    print(f'train steps: {idle / 2 ** 30:.2f} GiB held by the process before '
          f'the models are built (each peak below is above it)')

    st = state_of(SpeechDNN(), common.adam_with_clip(1e-3))
    step_times('speech dnn B=64 fp32', card, st,
               train_speech.make_steps(st.model)[0],
               {'x': randn(64, 56), 'label': onehot(randint(7, 64))}, 64,
               idle)
    st = state_of(BiLSTMTextModel(), common.adam_with_clip(1e-3))
    step_times('bi-lstm vocab 10000 seq 128 B=32 fp32', card, st,
               train_text_lstm.make_steps(st.model)[0],
               {'ids': randint(10000, 32, 128), 'label': randint(7, 32)}, 32,
               idle)
    text_batch = {'ids': randint(30522, 16, 128),
                  'mask': torch.ones(16, 128, dtype=torch.int32, device=dev),
                  'label': randint(7, 16)}
    sched = common.cosine_decay_schedule(2e-5, 100)
    for label, bf16, accum, remat in (('fp32', False, 1, False),
                                      ('bf16', True, 1, False),
                                      ('fp32 grad-accum 2 remat', False, 2,
                                       True)):
        tx = common.adamw_with_clip(sched)
        if accum > 1:
            tx = common.multi_steps(tx, accum)
        st = state_of(BertForSequenceClassification(remat=remat), tx)
        ms = step_times(f'bert-base 12x768 B=16 seq 128 {label}'
                        + (' (per micro-step)' if accum > 1 else ''), card,
                        st, train_text_bert.make_steps(st.model, bf16)[0],
                        text_batch, 16, idle, profiled=accum == 1)
        if accum > 1:
            print(f'train step bert-base grad-accum 2: {2 * ms:.3f} ms per '
                  f'optimizer update of 32 samples; {card}')
        if label == 'fp32':
            st.model.eval()
            store.save_params(os.path.join(serve_dir, 'bert_model',
                                           'bert_model.mecp'),
                              to_jax(st.model), meta={'val_acc': 0.0})
        del st
        torch.cuda.empty_cache()
    with open(os.path.join(serve_dir, 'bert_model', 'config.json'), 'w') as f:
        json.dump({c: d for _k, (c, d) in WIDTHS.items()}, f)
    vocab = make_vocab()
    with open(os.path.join(serve_dir, 'bert_model', 'vocab.txt'), 'w') as f:
        f.write('\n'.join(sorted(vocab, key=vocab.get)))
    img_batch = {'img': randint(256, 32, 224, 224, 3).to(torch.uint8),
                 'label': randint(7, 32)}
    for arch, label, tx, bf16 in (
            ('resnet50', 'phase 1 (frozen backbone) fp32',
             train_image.make_tx(1e-4, 1e-3, True), False),
            ('resnet50', 'phase 2 fp32', common.adamw_with_clip(sched), False),
            ('resnet50', 'phase 2 bf16', common.adamw_with_clip(sched), True),
            ('mobilenet_v2', 'phase 2 fp32', common.adamw_with_clip(sched),
             False)):
        st = state_of(train_image.ARCHS[arch](), tx)
        step_times(f'{arch} 224 px B=32 {label}', card, st,
                   train_image.make_steps(st.model, bf16)[0], img_batch, 32,
                   idle, profiled=label.startswith('phase 2')
                   and arch == 'resnet50')
        if arch == 'resnet50' and label == 'phase 2 fp32':
            st.model.eval()
            store.save_params(os.path.join(serve_dir, 'image_model.mecp'),
                              to_jax(st.model),
                              meta={'val_acc': 0.0, 'arch': arch,
                                    'img_size': 224})
        del st
        torch.cuda.empty_cache()
    cfg = {'speech_dim': 64, 'text_dim': 768, 'image_dim': 512,
           'num_classes': 7, 'hidden_dim': 256}
    st = state_of(MultiModalFusionModel(**cfg), common.adamw_with_clip(sched))
    probs = torch.softmax(randn(3, 64, 7), dim=-1)
    step_times('fusion B=64 fp32', card, st,
               train_fusion.make_steps(st.model)[0],
               {'s_feat': randn(64, 64), 't_feat': randn(64, 768),
                'i_feat': randn(64, 512), 's_pred': probs[0],
                't_pred': probs[1], 'i_pred': probs[2],
                'label': randint(7, 64)}, 64, idle)
    st.model.eval()
    store.save_params(os.path.join(serve_dir, 'fusion_model.mecp'),
                      to_jax(st.model), meta={'config': cfg, 'val_acc': 0.0})
    del st
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cli_dir = os.path.join(work.name, 'cli_models')
    cli = subprocess.run(
        [sys.executable, '-m', 'mec_tpu_torch', 'train-speech', '--data-root',
         speech_root, '--epochs', '1', '--batch-size', '16', '--models-dir',
         cli_dir], cwd=HERE, capture_output=True, text=True, timeout=300)
    check(cli.returncode == 0 and sorted(os.listdir(cli_dir))
          == ['speech_model.mecp', 'speech_scaler.npz'],
          f'python -m mec_tpu_torch train-speech failed: {cli.stderr[-2000:]}')
    print(f'train cli: python -m mec_tpu_torch train-speech --epochs 1 '
          f'(device cuda) wrote {sorted(os.listdir(cli_dir))} in '
          f'{time.perf_counter() - t0:.1f} s')

    # c. serve the trained directory: the full-width speech DNN and Bi-LSTM
    # of the gates (their default widths are the full ones) beside
    # BERT-base, ResNet50 and the fusion net of the step timings
    for f in ('speech_model.mecp', 'speech_scaler.npz', 'text_model.mecp',
              'text_model_tokenizer.json'):
        shutil.copy(os.path.join(gate_dir, f), os.path.join(serve_dir, f))
    saved = Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION
    Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = \
        'attention', 'bfloat16', 'high'
    try:
        eng = get_engine(serve_dir, reload=True, device='cuda')
        check(eng._all_live and eng.lstm is not None
              and eng._fusion_kind == 'attention'
              and eng._image_arch == 'resnet50', 'the trained directory did '
              'not load every model')
        for w in wrappers.values():
            w.launches = 0
        got = [eng.predict_multimodal(**r) for r in requests[:4]]
        counts = {name: w.launches for name, w in wrappers.items()}
        for name, n in counts.items():
            want = 0 if name == 'dft_spectrograms' else 4
            check(n == want, f'trained dir: {name} launched {n} times in 4 '
                  f'tri-modal dispatches (want {want})')
        lstm_got = eng.predict_texts_lstm(TEXTS)
        cpu = EmotionEngine.from_models_dir(serve_dir, device='cpu')
        check(cpu._image_scales_cached and cpu._bert_scales_cached,
              'the cpu engine did not take the card\'s scales')
        ref = [cpu.predict_multimodal(**r) for r in requests[:4]]
        errs = {}
        for mod, band in (('speech', SPEECH_BAND), ('text', TRI_BAND),
                          ('image', IMAGE_BAND), ('fusion', TRI_BAND)):
            errs[mod] = check_results([g[mod] for g in got],
                                      [r[mod] for r in ref], band,
                                      f'trained dir bf16 {mod}')
        errs['lstm bf16'] = check_results(lstm_got,
                                          cpu.predict_texts_lstm(TEXTS),
                                          TRI_BAND, 'trained dir bf16 lstm')
        Config.COMPUTE_DTYPE = 'float32'
        e32 = EmotionEngine.from_models_dir(serve_dir, device='cuda')
        c32 = EmotionEngine.from_models_dir(serve_dir, device='cpu')
        errs['lstm fp32'] = check_results(e32.predict_texts_lstm(TEXTS),
                                          c32.predict_texts_lstm(TEXTS),
                                          1e-4, 'trained dir fp32 lstm')
        print(f'train serve: get_engine on the trained directory (bf16, '
              f'int8 static BERT-base and ResNet50, the Bi-LSTM): launches '
              f'in 4 tri-modal dispatches {counts}; agreement with the cpu '
              f'engine ' + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
        del eng, cpu, e32, c32
    finally:
        Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = saved
    work.cleanup()
    torch.cuda.empty_cache()
    print(f'train phase wall: {time.perf_counter() - t_phase:.1f} s; {card}')


# bf16 MoE tri-modal card engine against the same engine on the CPU
# (given the card's static scales). Measured (NVIDIA H100 80GB HBM3,
# 700.00 W, against its host's CPU, two runs alike): text 0.0474, image
# 0.0067, fusion 0.0015, with 31 of 4,272 token-layer routes sent to
# another expert than on the CPU (none in layer 0, rising to 6 of 194
# in layer 11 at seq 128). The dense BERT's drift (TRI_BAND: LayerNorms
# one bf16 step apart, up to 0.085 on the dense synthetic BERT-base)
# feeds the router, and a flip moves one token's FFN output in one
# layer; the difference measured with flips stays under the dense
# drift's, so the band is the dense one, for that reason
MOE_TRI_BAND = 1e-1
# the texts that land in each sequence bucket (make_vocab's words)
SEQ_TEXTS = {16: 'i am so happy today', 32: ' '.join(['happy', 'sad'] * 10),
             128: ' '.join(['angry', 'calm', 'day'] * 30)}


def moe_routes(model, ids, mask):
    """Each MoE layer's expert choice of every real token, read off the
    layer's own input by forward hooks (a list of (B, L) int arrays, -1
    where the token is padding), and the model's probabilities."""
    import torch
    import torch.nn.functional as F

    from mec_tpu_torch.models.batchnorm import wide
    from mec_tpu_torch.models.moe import MoEFFN
    routes, hooks = [], []

    def hook(m, inputs, _out):
        h, tok = inputs
        logits = F.linear(wide(h), m.router.weight.float(),
                          m.router.bias.float())
        r = torch.argmax(torch.softmax(logits, -1), -1)
        routes.append(torch.where(tok, r, -1).cpu().numpy())
    for mod in model.modules():
        if isinstance(mod, MoEFFN):
            hooks.append(mod.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            logits, _cls = model(ids, mask)
    finally:
        for h in hooks:
            h.remove()
    return routes, torch.softmax(logits, -1).cpu().numpy()


def moe_phase(card, wrappers, tri_waves, tri_pics):
    """6c. moe: a full-width MoE BERT (BERT-base widths, E=4, capacity
    1.25) served by get_engine in bf16 inside the tri-modal step, held
    against the cpu engine with routing flips counted, an fp32 card
    engine against the cpu, its device step timed and profiled; the
    MoE trainer at full width and through the tiny BERT gate. Returns
    the kernels' launches in the served dispatches."""
    import torch

    from mec_tpu_torch.config import Config
    from mec_tpu_torch.convert import store
    from mec_tpu_torch.models.bert import BertForSequenceClassification
    from mec_tpu_torch.serving.engine import EmotionEngine, get_engine
    from mec_tpu_torch.serving.synthetic_artifacts import \
        write_synthetic_artifacts
    from mec_tpu_torch.training import common, corpora, train_text_bert
    t_phase = time.perf_counter()
    dev = torch.device('cuda')
    work = tempfile.TemporaryDirectory(prefix='chip_smoke_moe_')
    mdir = os.path.join(work.name, 'models')
    t0 = time.perf_counter()
    write_synthetic_artifacts(mdir, seed=MODELS_SEED, image_size=224,
                              bert_experts=4, moe_capacity_factor=1.25)
    cfg = json.load(open(os.path.join(mdir, 'bert_model', 'config.json')))
    print(f'moe: full-width directory written in '
          f'{time.perf_counter() - t0:.2f} s (BERT-base widths, '
          f'{cfg["num_experts"]} experts, capacity factor '
          f'{cfg["moe_capacity_factor"]}, ResNet50 224 px)')
    saved = Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION
    Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = \
        'attention', 'bfloat16', 'high'
    try:
        t0 = time.perf_counter()
        eng = get_engine(mdir, reload=True)          # the default device
        check(eng.device.type == 'cuda' and eng._all_live
              and eng.bert['model'].num_experts == 4
              and eng._bert_quant_mode == eng._image_quant_mode == 'static'
              and eng._fusion_kind == 'attention',
              'get_engine did not build the bf16 MoE tri-modal engine on '
              'the card')
        print(f'moe engine: get_engine on cuda (bf16, int8 static '
              f'attention, bf16 experts, ResNet50 int8 static) in '
              f'{time.perf_counter() - t0:.2f} s, calibrated on the card')
        seqs = sorted(SEQ_TEXTS)
        t0 = time.perf_counter()
        for w in wrappers.values():
            w.launches = 0
        eng.warmup((1, 8, 32))
        rows = {}
        for B in (1, 8, 32):
            for s in seqs:
                rows[B, s] = eng._run_trimodal(tri_waves[:B],
                                               [SEQ_TEXTS[s]] * B,
                                               tri_pics[:B])
        counts = {name: w.launches for name, w in wrappers.items()}
        dispatches = 3 + 3 * len(seqs) + 9
        print(f'moe engine: {dispatches} dispatches of each modality leg (3 '
              f'single-modality warmup, {3 * len(seqs)} tri-modal warmup, 9 '
              f'tri-modal at B=1, 8, 32 x seq {seqs}) in '
              f'{time.perf_counter() - t0:.1f} s; launches {counts}')
        for name, n in counts.items():
            want = 0 if name == 'dft_spectrograms' else dispatches
            check(n == want, f'moe engine: {name} launched {n} times in '
                  f'{dispatches} dispatches (want {want})')
        for (B, s), r in rows.items():
            check(r.shape == (B, 34) and bool(np.isfinite(r).all()),
                  f'moe rows B={B} seq {s}: {r.shape}')
            ids, _m = eng._text_wire([SEQ_TEXTS[s]], 1)
            check(ids.shape[1] == s, f'text of bucket {s} sliced to '
                  f'{ids.shape[1]}')

        t0 = time.perf_counter()
        cpu = EmotionEngine.from_models_dir(mdir, device='cpu')
        check(cpu._bert_scales_cached and cpu._image_scales_cached,
              'the cpu MoE engine did not take the card\'s scales')
        texts = [SEQ_TEXTS[s] for s in seqs] + TEXTS[:5]
        k_rows = eng._run_trimodal(tri_waves[:8], texts, tri_pics[:8])
        c_rows = cpu._run_trimodal(tri_waves[:8], texts, tri_pics[:8])
        e_parts = {part: float(np.abs(k_rows[:, a:b] - c_rows[:, a:b]).max())
                   for part, a, b in (('speech', 0, 7), ('text', 7, 14),
                                      ('image', 14, 21), ('fusion', 21, 28),
                                      ('attn', 28, 31), ('decision', 31, 34))}
        errs, flips = {}, {}
        for s in seqs:
            ids, mask = eng._text_wire([SEQ_TEXTS[s]] + TEXTS[:7], 8)
            (k_r, k_p), (c_r, c_p) = (
                moe_routes(e.bert['model'], *e._to_device((ids, mask)))
                for e in (eng, cpu))
            errs[s] = float(np.abs(k_p - c_p).max())
            real = [a >= 0 for a in k_r]
            flips[s] = (sum(int((a[m] != b[m]).sum())
                            for a, b, m in zip(k_r, c_r, real)),
                        sum(int(m.sum()) for m in real),
                        [int((a[m] != b[m]).sum())
                         for a, b, m in zip(k_r, c_r, real)])
        print(f'moe engine: agrees with from_models_dir(device=cpu) (scales '
              f'from the cache; built, and 4 batches of 8 run on the cpu, in '
              f'{time.perf_counter() - t0:.1f} s): the B=8 tri-modal rows '
              f'(seq 128) by part ' + ', '.join(f'{k} {v:.3e}'
                                                for k, v in e_parts.items())
              + '; the text probabilities by sequence bucket '
              + ', '.join(f'seq {s} {e:.3e}' for s, e in errs.items())
              + f', all <= MOE_TRI_BAND {MOE_TRI_BAND}; tokens routed to '
              f'another expert than on the cpu, of the token-layer routes: '
              + ', '.join(f'seq {s} {f[0]} of {f[1]} (by layer {f[2]})'
                          for s, f in flips.items()))
        check(max(e_parts.values()) <= MOE_TRI_BAND, f'moe bf16 tri-modal '
              f'rows differ from cpu: {e_parts} > {MOE_TRI_BAND}')
        for s, e in errs.items():
            check(e <= MOE_TRI_BAND, f'moe bf16 seq {s}: text probabilities '
                  f'differ from cpu by {e} > {MOE_TRI_BAND}')
        del cpu

        Config.COMPUTE_DTYPE = 'float32'
        t0 = time.perf_counter()
        e32 = EmotionEngine.from_models_dir(mdir, device='cuda')
        c32 = EmotionEngine.from_models_dir(mdir, device='cpu')
        texts = [SEQ_TEXTS[s] for s in seqs] + TEXTS[:1]
        k32 = e32._run_trimodal(tri_waves[:4], texts, tri_pics[:4])
        c32r = c32._run_trimodal(tri_waves[:4], texts, tri_pics[:4])
        e_32 = float(np.abs(k32 - c32r).max())
        ids, mask = e32._text_wire(texts, 4)
        f32 = [0, 0]
        for a, b in zip(*(moe_routes(e.bert['model'],
                                     *e._to_device((ids, mask)))[0]
                          for e in (e32, c32))):
            real = a >= 0
            f32[0] += int((a[real] != b[real]).sum())
            f32[1] += int(real.sum())
        print(f'moe engine (fp32 parity): the card agrees with device=cpu '
              f'(all 34 packed values max|err| {e_32:.3e} <= 1e-4 at B=4, '
              f'one text of each bucket; routing flips {f32[0]} of '
              f'{f32[1]} token-layer routes; {time.perf_counter() - t0:.1f} '
              f's with both engines\' builds)')
        check(e_32 <= 1e-4, f'moe fp32: packed values differ from cpu by '
              f'{e_32} > 1e-4')
        del e32, c32
    finally:
        Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = saved

    t0 = time.perf_counter()
    for B, s in ((1, 16), (32, 128)):
        ids, mask = eng._to_device(eng._text_wire([SEQ_TEXTS[s]] * B, B))
        args = (eng._to_device(eng._wire_waves(tri_waves[:B], B)), ids,
                mask, eng._to_device(eng._wire_image(tri_pics[:B], B)))
        step = cuda_ms(lambda: eng._trimodal_forward(*args), reps=20)
        text = cuda_ms(lambda: eng._text_forward(ids, mask), reps=10)
        wall, busy, share, ops, top = profile_step(
            lambda: eng._trimodal_forward(*args), steps=5)
        extra = (f'; profiled wall {wall:.3f} ms, device busy '
                 f'{busy:.3f} ms, busy share {share:.3f}, {ops:.0f} '
                 f'device ops/step, most: {top[0][0]} '
                 f'{top[0][1]:.3f} ms' if top else
                 '; profiled window lost its launches')
        print(f'time moe trimodal device step B={B:2d} seq {s:3d}: '
              f'{step:.4f} ms (CUDA events; its MoE text step alone '
              f'{text:.4f} ms){extra}; {card}')
    print(f'moe timings: {time.perf_counter() - t0:.1f} s')
    del eng
    torch.cuda.empty_cache()

    # the MoE trainer: full width, a few optimizer steps
    idle = torch.cuda.memory_allocated()
    gen = torch.Generator(device='cuda').manual_seed(0)
    batch = {'ids': torch.randint(5, 30522, (16, 128), device=dev,
                                  generator=gen),
             'mask': torch.ones(16, 128, dtype=torch.int32, device=dev),
             'label': torch.randint(0, 7, (16,), device=dev, generator=gen)}
    st = common.TrainState(common.flax_init(BertForSequenceClassification(
        num_experts=4), 0).to(dev), common.adamw_with_clip(
            common.cosine_decay_schedule(2e-5, 100)))
    step_times('moe bert-base 12x768 E=4 B=16 seq 128 fp32', card, st,
               train_text_bert.make_steps(st.model)[0], batch, 16, idle,
               profiled=True)
    del st, batch
    torch.cuda.empty_cache()

    # the tiny BERT gate with --experts 2, then its directory served
    texts, labels = corpora.make_text_corpus(per_class=12)
    tok = corpora.make_bert_tokenizer(texts)
    tiny = dict(vocab_size=len(tok.vocab), hidden_size=64, num_layers=2,
                num_heads=2, intermediate_size=128)
    gate_dir = os.path.join(work.name, 'gate', 'bert_model')
    t0 = time.perf_counter()
    _v, hist = train_text_bert.train(
        csv_path=None, texts=texts, labels=labels, tokenizer=tok, epochs=8,
        batch_size=16, max_length=16, learning_rate=5e-4, model_kwargs=tiny,
        models_dir=gate_dir, verbose=False, device='cuda', experts=2)
    acc = max(hist['val_acc'])
    cfg = json.load(open(os.path.join(gate_dir, 'config.json')))
    print(f'train gate bert --experts 2: best val_acc {acc:.4f} > '
          f'{GATES["bert"]} ({time.perf_counter() - t0:.1f} s on the card); '
          f'config.json num_experts {cfg.get("num_experts")}, '
          f'moe_capacity_factor {cfg.get("moe_capacity_factor")}')
    check(acc > GATES['bert'], f'train gate bert --experts 2: val_acc {acc} '
          f'<= {GATES["bert"]}')
    check(cfg.get('num_experts') == 2 and 'moe' in store.load_params(
        os.path.join(gate_dir, 'bert_model.mecp'))['variables']['params']
        ['layer_0'], 'the --experts 2 directory is not an MoE one')
    work.cleanup()
    print(f'moe phase wall: {time.perf_counter() - t_phase:.1f} s; {card}')
    return counts, dispatches


# phase 6d: the float64 gradients after the all-reduce against one
# process on the same global batch (a mean of two half-batch means
# against one mean: rounding only), on the card
DP_TOL = 1e-9


# the grouped expert GEMM against its plain version: h rounds to bf16 in
# both after float32 sums in other orders, so an element near a rounding
# boundary lands one bf16 ulp apart and down sums 1,408 of them; 5e-3 of
# the outputs' largest magnitude (tests/test_torch_moonlight.py). The
# faults it must catch (one 64-wide K-slice of down left out, one tile's
# rows shifted by a row) are computed beside it and must read above it
EXPERT_TOL = 5e-3
# the Moonlight leg's serving shapes: (batch, sequence bucket, real tokens)
EXPERT_SHAPES = ((1, 16, 12), (1, 32, 30), (1, 128, 100), (32, 128, 128))
MOONLIGHT_SEED = 3


def expert_gemm_bound():
    """benchmark/bounds/grouped_expert_gemm.py, the one definition of the
    kernel's bound (its bytes and operations a step of 26 layers)."""
    import importlib.util
    path = os.path.join(HERE, 'benchmark', 'bounds', 'grouped_expert_gemm.py')
    spec = importlib.util.spec_from_file_location('expert_gemm_bound', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the expert layer's glue kernels against their plain versions
# (tests/test_torch_moonlight.py): each row of h rms_norm's exactly at an
# rsqrt within GLUE_H_ULPS float32 ulps of torch's (the mean of squares
# sums in another order); the choice equal to topk of
# the float32 scores of the kernel's own h, in order, but where two
# neighbours of a token's top 7 biased scores lie within GLUE_NEAR
# relative (2,048 products summed in another order than cuBLAS's); the
# weights within GLUE_W_TOL relative (six scores summed in another order);
# the sort and the combine exact
GLUE_H_ULPS, GLUE_NEAR, GLUE_W_TOL = 8, 1e-5, 1e-6
GLUE_KERNELS = ('expert_router_kernel', 'expert_sort_kernel',
                'expert_combine_kernel')


def expert_glue_check(eg, p, text, x, valid, weights, shape):
    """6h: the router, the sort and the combine of layer p (its norm,
    gate and experts) on tokens x against their plain versions; returns
    each one's CUDA-event ms a call (median of 20)."""
    import torch
    gate = p['mlp']['gate']
    K, E, S = (text['num_experts_per_tok'], text['n_routed_experts'],
               text['n_shared_experts'])
    args = (p['post_attention_layernorm']['weight'], gate['weight'],
            gate['e_score_correction_bias'], text['rms_norm_eps'], K,
            text['norm_topk_prob'], text['routed_scaling_factor'])
    h, idx, w = eg.expert_router(x, *args)
    ph, _idx, _w = eg.expert_router_plain(x, *args)
    xf, norm_w = x.float(), args[0]
    r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + args[3])
    ok = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    lo, hi = r, r
    for _ in range(GLUE_H_ULPS + 1):
        for rr in (lo, hi):
            ok |= (norm_w * (xf * rr).to(x.dtype) == h).all(-1)
        lo = torch.nextafter(lo, torch.full_like(lo, -float('inf')))
        hi = torch.nextafter(hi, torch.full_like(hi, float('inf')))
    check(bool(ok.all()), f'expert_router {shape}: {int((~ok).sum())} rows '
          f'of h are not rms_norm\'s at any rsqrt within {GLUE_H_ULPS} ulps')
    scores = torch.sigmoid(h.float() @ gate['weight'].float().T)
    top = torch.topk(scores + gate['e_score_correction_bias'].float(), K + 1,
                     -1)
    near = ((top.values[:, :-1] - top.values[:, 1:])
            <= GLUE_NEAR * top.values[:, 1:].abs()).any(-1)
    want = top.indices[:, :K]
    s = scores.gather(1, want)
    if text['norm_topk_prob']:
        s = s / (s.sum(-1, keepdim=True) + 1e-20)
    want_w = s * text['routed_scaling_factor']
    w_err = ((w - want_w).abs() / want_w.abs())[~near].max().item()
    check(torch.equal(idx.long()[~near], want[~near]) and w_err <= GLUE_W_TOL,
          f'expert_router {shape}: the choice differs from topk of its '
          f'scores, or a weight by {w_err:.3e} relative (> {GLUE_W_TOL})')
    counters = torch.zeros(2, dtype=torch.int32, device=x.device)
    r = eg.sort_pairs(idx, w, valid, E, S, counters)
    want_r = eg.route(idx.long(), w, valid, E, S)
    per = want_r.counts[:E]
    check(all(torch.equal(getattr(r, f), getattr(want_r, f))
              for f in want_r._fields)
          and counters.tolist() == [int((per > 0).sum()), int(per.sum())],
          f'sort_pairs {shape}: not route()\'s Routing or counters')
    y = eg.grouped_expert_gemm(h, r, *weights)
    got = eg.combine_residual(x, y, r, valid)
    check(torch.equal(got, x + eg.combine(y, r, valid).to(x.dtype)),
          f'combine_residual {shape}: not bit for bit its plain version')
    ms = {'router': cuda_ms(lambda: eg.expert_router(x, *args), reps=20),
          'sort': cuda_ms(lambda: eg.sort_pairs(idx, w, valid, E, S,
                                                counters), reps=20),
          'combine': cuda_ms(lambda: eg.combine_residual(x, y, r, valid),
                             reps=20)}
    print(f'expert glue {shape}: router h rms_norm\'s at a nearby rsqrt ('
          f'{(h == ph).float().mean().item():.4f} bit-equal), choice equal '
          f'but {int(near.sum())} near-tied of {near.numel()} tokens, '
          f'weights within {w_err:.2e}; sort and combine exact; a call '
          + ', '.join(f'{k} {v:.4f} ms' for k, v in ms.items())
          + ' (CUDA events)')
    return ms


def moonlight_phase(card, speech_tree, scaler, img_tree, image_meta,
                    tri_waves, tri_pics):
    """6h. moonlight: Moonlight-16B-A3B's text leg at its published widths
    (benchmark/configs/moonlight16b_resnet50_attn.json; bf16 leaves drawn
    on the card by the benchmark's own leg) in a tri-modal engine with
    phase 6's speech and image trees and a fusion net at text_dim 2048.
    The grouped expert GEMM against its plain version at the four serving
    shapes on layer 1's experts, with the faults the tolerance must catch;
    then the engine's own run: warmup captures the nine shapes, the
    kernel's count is zeroed, b1 requests at sequence buckets 16, 32 and
    128 and one b32 x 128 dispatch are served (26 calls a dispatch), and a
    profiled window of each gives the kernel's device ms a dispatch
    beside its bound at the routing the program recorded. Returns the
    kernel's row of the report."""
    import torch

    from benchmark.legs import text_moonlight as leg
    from benchmark.weights import seeded
    from mec_tpu_torch.ops import expert_gemm as eg
    from mec_tpu_torch.serving.engine import EmotionEngine
    from mec_tpu_torch.serving.synthetic_artifacts import (fusion_variables,
                                                           make_vocab)
    from mec_tpu_torch.utils.profiling import timer as stage_timer
    t_phase = time.perf_counter()
    dev = torch.device('cuda')
    with open(os.path.join(HERE, 'benchmark', 'configs',
                           'moonlight16b_resnet50_attn.json')) as f:
        text = json.load(f)['text']
    bnd = expert_gemm_bound()
    t0 = time.perf_counter()
    mtree = seeded.materialize(seeded.bind(leg.plan(None, **text),
                                           MOONLIGHT_SEED, dev),
                               torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(mtree))
    print(f'moonlight: {n_params:,} bf16 parameters drawn on the card in '
          f'{time.perf_counter() - t0:.2f} s')

    # ---- the kernel against its plain version, and the faults it catches
    p1 = mtree['layers']['1']
    ml = p1['mlp']
    weights = (ml['experts']['gate_proj'], ml['experts']['up_proj'],
               ml['experts']['down_proj'],
               ml['shared_experts']['gate_proj']['weight'],
               ml['shared_experts']['up_proj']['weight'],
               ml['shared_experts']['down_proj']['weight'])
    E, S, K = text['n_routed_experts'], text['n_shared_experts'], \
        text['num_experts_per_tok']
    cut = weights[2].clone()
    cut[..., :64] = 0
    errs, alone = [], {}
    g = torch.Generator(device=dev).manual_seed(0)
    for B, L, real in EXPERT_SHAPES:
        T = B * L
        x = torch.randn(T, text['hidden_size'], generator=g,
                        device=dev).to(torch.bfloat16)
        valid = (torch.arange(L, device=dev) < real).repeat(B)
        idx = torch.topk(torch.rand(T, E, generator=g, device=dev), K,
                         -1).indices
        r = eg.route(idx, torch.rand(T, K, generator=g, device=dev), valid,
                     E, S)
        y = eg.grouped_expert_gemm(x, r, *weights)
        want = eg.grouped_expert_gemm_plain(x, r, *weights)
        n = int(r.offsets[-1])
        check(n == int(valid.sum()) * (K + S),
              f'grouped_expert_gemm b{B} x {L}: {n} pairs routed')
        top = want[:n].abs().max().item()
        err = (y[:n] - want[:n]).abs().max().item() / top
        k_cut = eg.grouped_expert_gemm_plain(x, r, weights[0], weights[1],
                                             cut, *weights[3:])
        k_err = (k_cut[:n] - want[:n]).abs().max().item() / top
        bm = eg.tile_rows(T)
        lo = int(r.offsets[int((r.counts[:E] >= 2).nonzero()[0])])
        shifted = want.clone()
        shifted[lo:lo + bm] = want[lo:lo + bm].roll(1, 0)
        t_err = (shifted[:n] - want[:n]).abs().max().item() / top
        check(err <= EXPERT_TOL, f'grouped_expert_gemm b{B} x {L}: {err:.3e}'
              f' of the largest output from the plain version > '
              f'{EXPERT_TOL}')
        check(min(k_err, t_err) > EXPERT_TOL,
              f'grouped_expert_gemm b{B} x {L}: a fault reads within the '
              f'tolerance (K-slice {k_err:.3e}, tile {t_err:.3e})')
        errs.append(err)
        ms = cuda_ms(lambda: eg.grouped_expert_gemm(x, r, *weights), reps=20)
        plain_ms = cuda_ms(lambda: eg.grouped_expert_gemm_plain(x, r,
                                                               *weights),
                           reps=5)
        alone[f'b{B}x{L}'] = {'ms': ms, 'plain_ms': plain_ms,
                              'glue_ms': expert_glue_check(
                                  eg, p1, text, x, valid, weights,
                                  f'b{B} x {L}')}
        print(f'kernel grouped_expert_gemm b{B} x {L} ({real} real tokens, '
              f'{int((r.counts[:E] > 0).sum())} experts touched): '
              f'{err:.3e} of the largest output from the plain version '
              f'(<= {EXPERT_TOL}); a K-slice of down left out reads '
              f'{k_err:.3e}, a tile shifted by a row {t_err:.3e}; one '
              f'layer {ms:.4f} ms (CUDA events), its plain version '
              f'{plain_ms:.4f} ms')
    del cut

    # ---- the engine's own run
    t0 = time.perf_counter()
    eng = EmotionEngine(
        speech_tree, scaler, image_variables=img_tree, image_meta=image_meta,
        text_arch='moonlight', text_variables=mtree, text_kwargs=text,
        text_vocab=make_vocab(),
        fusion_variables=fusion_variables(seed=FUSION_SEED,
                                          text_dim=text['hidden_size']),
        fusion_config={'text_dim': text['hidden_size']},
        compute_dtype='bfloat16', device='cuda')
    check(eng._all_live and eng.text_leg is not None
          and eng.text_leg.model.tree is mtree,
          'the Moonlight engine is not tri-modal, or copied its leaves')
    eng.warmup((1, 8, 32))
    check(len(eng._graphs) == 9, f'{len(eng._graphs)} captured tri-modal '
          'shapes, not 9')
    print(f'moonlight engine: built and warmed up (9 graphs) in '
          f'{time.perf_counter() - t0:.2f} s; memory allocated '
          f'{torch.cuda.memory_allocated() / 1e9:.1f} GB')

    def batch(B, s):
        return [{'audio_path': 'tri.wav', 'image_path': 'tri.png',
                 'text': SEQ_TEXTS[s], 'wave': tri_waves[i],
                 'image': tri_pics[i]} for i in range(B)]
    layers = text['num_hidden_layers'] - text['first_k_dense_replace']
    names = tuple(bnd.GLOBALS)
    glue = (eg.expert_router, eg.sort_pairs, eg.combine_residual)
    for wrapper in (eg.grouped_expert_gemm, *glue):
        wrapper.launches = 0
    dispatches = 0
    by_shape = {}
    for B, s in ((1, 16), (1, 32), (1, 128), (32, 128)):
        reqs = batch(B, s)
        stage_timer.reset()
        for _ in range(3):
            out = eng.predict_multimodal_batch(reqs)
        dispatches += 3
        check(all('attention_weights' in o['fusion'] for o in out),
              f'moonlight b{B} x {s}: a request was not served')
        rec = stage_timer.summary()
        touched = rec['text.moe.experts_touched']['mean_ms']
        pairs = rec['text.moe.routed_pairs']['mean_ms']
        kern = profiled_launches(lambda: eng.predict_multimodal_batch(reqs),
                                 5)
        dispatches += 5 + 5 + 3
        mine = [e for e in kern if any(n in e.name for n in names)]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 5e3
        ms = sum(e.time_range.elapsed_us() for e in mine) / 5e3
        b_ms = bnd.bound_ms(B, experts_touched=touched, routed_pairs=pairs)
        glue_ms = {n: sum(e.time_range.elapsed_us() for e in kern
                          if n in e.name) / 5e3 for n in GLUE_KERNELS}
        by_shape[f'b{B}x{s}'] = {
            'device_ms': ms if mine else None, 'bound_ms': b_ms,
            'share': None if not mine else b_ms / ms,
            'launches_seen': len(mine) / 5, 'experts_touched': touched,
            'routed_pairs': pairs, 'busy_ms': busy,
            'kernels_a_dispatch': len(kern) / 5, 'glue_device_ms': glue_ms}
        print(f'moonlight b{B} x {s}: {touched:.2f} experts touched and '
              f'{pairs:.1f} routed pairs a layer (the program\'s record); '
              f'grouped_expert_gemm {fmt_ms(ms if mine else None)} of '
              f'{busy:.4f} ms device busy a dispatch in {len(mine) / 5:.0f}'
              f' launches, bound {b_ms:.4f} ms, share '
              + ('not measured' if not mine else f'{b_ms / ms:.3f}')
              + f'; {len(kern) / 5:.1f} device launches a dispatch, the glue '
              + ', '.join(f'{n} {v:.4f} ms' for n, v in glue_ms.items())
              + f' a dispatch; {card}')
    calls = eg.grouped_expert_gemm.launches
    check(calls == layers * dispatches,
          f'grouped_expert_gemm: {calls} calls in {dispatches} dispatches, '
          f'not {layers} a dispatch')
    for wrapper in glue:
        check(wrapper.launches == layers * dispatches,
              f'{wrapper.__name__}: {wrapper.launches} calls in '
              f'{dispatches} dispatches, not {layers} a dispatch')
    del eng, mtree, ml, weights
    torch.cuda.empty_cache()
    print(f'moonlight phase wall: {time.perf_counter() - t_phase:.1f} s; '
          f'{card}')
    top = by_shape['b32x128']
    for k, v in alone.items():
        by_shape[k].update(layer_ms=v['ms'], layer_plain_ms=v['plain_ms'],
                           glue_ms=v['glue_ms'])
    print(f'expert glue: {layers} calls a dispatch each of '
          + ', '.join(w.__name__ for w in glue) + f' in {dispatches} '
          f'dispatches; {card}')
    return {'name': 'grouped_expert_gemm', 'route': 'cuda',
            'source': 'mec_tpu_torch/csrc/grouped_expert_gemm.cu',
            'replaces': None, 'launches': calls * bnd.LAUNCHES,
            'launches_by_path': {'moonlight_trimodal': calls * bnd.LAUNCHES},
            'launches_per_dispatch': calls * bnd.LAUNCHES / dispatches,
            'max_abs_err': max(errs), 'ms': alone['b32x128']['ms'],
            'plain_ms': alone['b32x128']['plain_ms'],
            'device_ms': top['device_ms'],
            'bound_ms': top['bound_ms'], 'share': top['share'],
            'by_shape': by_shape}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def dp_grads(device, mesh):
    """One float64 training step of the fusion net, the speech DNN
    (BatchNorm statistics) and a tiny MoE BERT (the aux loss) on this
    rank's rows of a seeded global batch of 16 (all rows without a
    mesh): {case: (loss, the gradients the optimizer was handed)}."""
    import torch

    from mec_tpu_torch.models.bert import BertForSequenceClassification
    from mec_tpu_torch.models.fusion import MultiModalFusionModel
    from mec_tpu_torch.models.speech_dnn import SpeechDNN
    from mec_tpu_torch.parallel import mesh as pmesh
    from mec_tpu_torch.training import (common, train_fusion, train_speech,
                                        train_text_bert)

    class Recording(common.Tx):
        def step(self, grads, state, params, norm_fn=None):
            self.grads = [g.double().cpu().numpy() for g in grads]
            super().step(grads, state, params, norm_fn)

    rng = np.random.RandomState(3)
    B = 16
    probs = rng.dirichlet(np.ones(7), (3, B))
    mask = np.cumprod(np.arange(12)[None] < rng.randint(3, 13, (B, 1)), 1)
    cases = {
        'fusion': (MultiModalFusionModel(speech_dim=8, text_dim=12,
                                         image_dim=10, hidden_dim=16,
                                         dtype=torch.float64),
                   train_fusion.make_steps,
                   {'s_feat': rng.randn(B, 8), 't_feat': rng.randn(B, 12),
                    'i_feat': rng.randn(B, 10), 's_pred': probs[0],
                    't_pred': probs[1], 'i_pred': probs[2],
                    'label': rng.randint(0, 7, B)}),
        'speech': (SpeechDNN(), train_speech.make_steps,
                   {'x': rng.randn(B, 56),
                    'label': np.eye(7)[rng.randint(0, 7, B)]}),
        'moe_bert': (BertForSequenceClassification(
            vocab_size=50, hidden_size=16, num_layers=2, num_heads=2,
            intermediate_size=32, max_position=32, num_experts=2,
            moe_capacity_factor=1.0, dtype=torch.float64),
            train_text_bert.make_steps,
            {'ids': rng.randint(5, 50, (B, 12)) * mask,
             'mask': mask.astype(np.int32), 'label': rng.randint(0, 7, B)})}
    out = {}
    for name, (model, make, batch) in cases.items():
        model = common.flax_init(model, 0).double().to(device)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        if mesh is not None:
            batch = mesh.shard_rows(batch)
        state = common.TrainState(model, Recording({'all': common.Adam(1e-3)}))
        model.train()
        with pmesh.data_parallel(mesh):
            loss = make(model)[0](state, common.to_device(batch, device))
        out[name] = (float(loss.detach()), state.tx.grads)
    return out


def dp_fit(device, mesh):
    """3 epochs of the fusion net (fp32, 96 training rows in batches of
    16: no ragged tail) through common.fit: (history, parameters)."""
    import torch

    from mec_tpu_torch.models.fusion import MultiModalFusionModel
    from mec_tpu_torch.training import common, train_fusion
    rng = np.random.RandomState(5)
    n = 128
    data = {'s_feat': rng.randn(n, 8), 't_feat': rng.randn(n, 12),
            'i_feat': rng.randn(n, 10),
            's_pred': rng.dirichlet(np.ones(7), n),
            't_pred': rng.dirichlet(np.ones(7), n),
            'i_pred': rng.dirichlet(np.ones(7), n)}
    data = {k: v.astype(np.float32) for k, v in data.items()}
    data['label'] = rng.randint(0, 7, n)
    model = common.flax_init(MultiModalFusionModel(
        speech_dim=8, text_dim=12, image_dim=10, hidden_dim=16), 0)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    state = common.TrainState(model.to(device), common.adam_with_clip(1e-3))
    steps = train_fusion.make_steps(model)
    _s, _best, hist = common.fit(
        state, {k: v[:96] for k, v in data.items()},
        {k: v[96:] for k, v in data.items()}, *steps, epochs=3,
        batch_size=16, seed=4, log_fn=lambda *_: None, mesh=mesh)
    return hist, [p.detach().cpu().numpy() for p in state.params]


def allreduce_ms(mesh, device, mib=64, reps=5):
    """Host-clock milliseconds of one all-reduce (mean) of an fp32 buffer
    of `mib` MiB on `device`, median of `reps` after 2 warm-up calls."""
    import torch
    buf = torch.ones(mib * 2 ** 18, device=device)
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.all_reduce_([buf], mean=True)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def dp_rank():
    """One rank of phase 6d (two gloo ranks on one card)."""
    import torch

    from mec_tpu_torch.training import common
    mesh = common.data_mesh(2)
    dev = torch.device('cuda', torch.cuda.current_device())
    grads = dp_grads(dev, mesh)
    hist, params = dp_fit(dev, mesh)
    return {'grads': grads, 'hist': hist, 'params': params,
            'allreduce_64mib_ms': allreduce_ms(mesh, dev)}


def dp_phase(card):
    """6d. data-parallel: two gloo ranks on the card against one process;
    one NCCL rank initialized from the MEC_* variables; the CLI refusing
    --mesh-data 2 on one card."""
    import torch
    import torch.distributed as dist

    from mec_tpu_torch.parallel import distributed, launch
    from mec_tpu_torch.parallel import mesh as pmesh
    t_phase = time.perf_counter()
    ranks = launch.launch(dp_rank, 2, devices=['cuda:0', 'cuda:0'],
                          backend='gloo', timeout=600)
    ref = dp_grads(torch.device('cuda'), None)
    errs = {}
    for name, (loss, grads) in ref.items():
        scale = max(float(np.abs(g).max()) for g in grads)
        errs[name] = max(float(np.abs(a - b).max()) for r in ranks
                         for a, b in zip(r['grads'][name][1], grads))
        mean_loss = (ranks[0]['grads'][name][0]
                     + ranks[1]['grads'][name][0]) / 2
        check(errs[name] <= DP_TOL and abs(mean_loss - loss) <= DP_TOL,
              f'dp {name}: averaged gradients differ from one process by '
              f'{errs[name]} (loss {mean_loss} vs {loss}) > {DP_TOL}')
        errs[name] = (errs[name], scale)
    check(ranks[0]['hist'] == ranks[1]['hist']
          and all(np.array_equal(a, b) for a, b in
                  zip(ranks[0]['params'], ranks[1]['params'])),
          'dp: the two ranks\' histories or parameters differ')
    one_hist, _p = dp_fit(torch.device('cuda'), None)
    e_loss = max(abs(a - b) / abs(b) for a, b in
                 zip(ranks[0]['hist']['loss'], one_hist['loss']))
    check(e_loss <= 1e-3 and ranks[0]['hist']['val_acc'] ==
          one_hist['val_acc'], f'dp fit: loss {ranks[0]["hist"]["loss"]} vs '
          f'one process {one_hist["loss"]}')
    print('dp gloo (2 ranks sharing cuda:0, gloo all-reducing CUDA tensors, '
          'BatchNorm and the MoE aux through the autograd all-reduce): '
          'float64 averaged gradients against one process on the same '
          'global batch of 16, max|err| (largest gradient) '
          + ', '.join(f'{k} {e:.2e} ({s:.2e})' for k, (e, s) in errs.items())
          + f' <= {DP_TOL}; 3-epoch fp32 fusion fit: both ranks\' histories '
          f'and parameters identical, loss within {e_loss:.2e} relative of '
          f'one process, val_acc equal; all-reduce of 64 MiB fp32 '
          f'{ranks[0]["allreduce_64mib_ms"]:.2f} ms (host clock, gloo); '
          f'{card}')

    # one NCCL rank from the MEC_* variables: a multi-GPU machine's path
    env = {'MEC_COORDINATOR_ADDRESS': f'localhost:{launch.free_port()}',
           'MEC_NUM_PROCESSES': '1', 'MEC_PROCESS_ID': '0'}
    os.environ.update(env)
    try:
        check(distributed.initialize_multi_host()
              and dist.get_backend() == 'nccl', 'initialize_multi_host did '
              'not start an NCCL group from the MEC_* variables')
        mesh = pmesh.make_mesh(1)
        got = dp_grads(torch.device('cuda'), mesh)
        e1 = max(float(np.abs(a - b).max()) for name in ref
                 for a, b in zip(got[name][1], ref[name][1]))
        check(e1 <= DP_TOL, f'dp nccl world 1: gradients differ by {e1}')
        nccl_ms = allreduce_ms(mesh, torch.device('cuda'))
        print(f'dp nccl (world size 1 from MEC_* variables): the gradient '
              f'all-reduce runs, gradients within {e1:.2e} of no group; '
              f'all-reduce of 64 MiB fp32 {nccl_ms:.3f} ms (host clock); '
              f'{card}')
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            del os.environ[k]

    cli = subprocess.run(
        [sys.executable, '-m', 'mec_tpu_torch', 'train-fusion',
         '--mesh-data', '2', '--epochs', '1'], cwd=HERE, capture_output=True,
        text=True, timeout=300)
    n_gpu = torch.cuda.device_count()
    check(cli.returncode != 0 and 'needs 2 GPUs' in cli.stderr
          and f'{n_gpu} is visible' in cli.stderr,
          f'train-fusion --mesh-data 2 on {n_gpu} GPU did not refuse: '
          f'{cli.returncode} {cli.stderr[-1000:]}')
    print(f'dp cli: python -m mec_tpu_torch train-fusion --mesh-data 2 '
          f'refused on {n_gpu} visible GPU: '
          f'{cli.stderr.strip().splitlines()[-1][:200]}')
    print(f'dp phase wall: {time.perf_counter() - t_phase:.1f} s; {card}')


# phase 6e: serving data parallelism (two replicas sharing the card) and
# the BERT trainer's model and pipe axes (two gloo ranks sharing it)
SERVE_DP_TOL32 = 1e-5      # fp32 rows of the replicas against one engine
AXES_TOL = 1e-10           # float64 gradients, relative to the largest


def serve_dp_phase(card, wrappers):
    """6e (serving). get_engine(dir, mesh=['cuda:0', 'cuda:0']) on a
    full-width directory (BERT-base, ResNet50 224 px, attention fusion),
    bf16: tri-modal requests at B=1, 8, 32 through predict_multimodal_
    batch, each of K1-K4, K6, K7 launched once a replica a dispatch;
    every replica's rows bit for bit those of a single-replica engine fed
    the same rows at the same per-replica bucket, the whole within
    dp_scaling.SERVE_DP_BAND of mesh=None; fp32 within SERVE_DP_TOL32.
    The directory's speech scaler is fitted to seeded clips (bench/dp_scaling.
    fit_speech_scaler: with the writer's identity scaler the tiny logits'
    rounding says nothing of the split). Returns (launch counts, tri-modal
    dispatches)."""
    import torch

    from mec_tpu_torch.bench import dp_scaling
    from mec_tpu_torch.config import Config
    from mec_tpu_torch.ops.quant import extract_static_scales
    from mec_tpu_torch.serving.engine import EmotionEngine, get_engine
    from mec_tpu_torch.serving.synthetic_artifacts import \
        write_synthetic_artifacts
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_serve_dp_')
    write_synthetic_artifacts(tmp.name, seed=MODELS_SEED)
    dp_scaling.fit_speech_scaler(tmp.name, waves(32, 97))
    inputs = {B: (waves(B, 40 + B), (TEXTS * 4)[:B], images(B, 50 + B))
              for B in (1, 8, 32)}
    saved = Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION
    Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = \
        'attention', 'bfloat16', 'high'
    try:
        one = EmotionEngine.from_models_dir(tmp.name, device='cuda',
                                            mesh=None)
        eng = get_engine(tmp.name, reload=True,
                         mesh=['cuda:0', 'cuda:0'])
        check(len(eng.replicas) == 2 and eng._all_live
              and all(r.device == torch.device('cuda', 0)
                      for r in eng.replicas)
              and eng._bucket(1) == 2 and eng._bucket(9) == 32,
              'get_engine(mesh=[cuda:0, cuda:0]) did not build two replicas')
        for what in ('bert', 'image'):
            check(extract_static_scales(getattr(eng, what)['variables'])
                  == extract_static_scales(getattr(one, what)['variables']),
                  f'serve dp: the replicas\' {what} int8 scales are not the '
                  f'single engine\'s')
        eng.warmup((1,))
        for w in wrappers.values():
            w.launches = 0
        for B, (w, t, im) in inputs.items():
            out = eng.predict_multimodal_batch(
                [{'audio_path': f'{i}.wav', 'text': t[i],
                  'image_path': f'{i}.png', 'wave': w[i], 'image': im[i]}
                 for i in range(B)])
            check(len(out) == B and all(set(r) == {'speech', 'text', 'image',
                                                   'fusion'} for r in out),
                  f'serve dp: B={B} results malformed')
        counts = {name: w.launches for name, w in wrappers.items()}
        want = {n: 2 * len(inputs) for n in wrappers}
        want['dft_spectrograms'] = 0
        check(counts == want, f'serve dp: launches {counts}, expected each '
              f'of K1-K4, K6, K7 once a replica a dispatch: {want}')
        errs = {}
        for B, (w, t, im) in inputs.items():
            exact, errs[B] = dp_scaling.replica_check(eng, one, w, t, im)
            check(exact, f'serve dp bf16 B={B}: a replica\'s rows differ '
                  f'from the single-replica engine on the same rows')
            check(errs[B] <= dp_scaling.SERVE_DP_BAND,
                  f'serve dp bf16 B={B}: {errs[B]} from mesh=None > '
                  f'{dp_scaling.SERVE_DP_BAND}')
        walls = {}
        for B in (1, 32):
            w, t, im = inputs[B]
            for name, e in (('1 replica', one), ('2 replicas', eng)):
                walls[name, B] = dp_scaling.host_wall_ms(
                    lambda: e._run_trimodal(w, t, im), reps=10)
        print('serve dp bf16 (2 replicas sharing cuda:0, get_engine(mesh=)): '
              'K1-K4, K6, K7 launched once a replica a dispatch '
              f'({2 * len(inputs)} in {len(inputs)} dispatches, B=1, 8, '
              '32); each replica\'s rows bit for bit the single-replica '
              'engine\'s on the same rows; against mesh=None max|err| '
              + ', '.join(f'B={B} {e:.3e}' for B, e in errs.items())
              + f' (band {dp_scaling.SERVE_DP_BAND}); tri-modal dispatch '
              'host wall '
              + ', '.join(f'{n} B={B} {ms:.3f} ms'
                          for (n, B), ms in walls.items()) + f'; {card}')
        del eng, one
        Config.COMPUTE_DTYPE = 'float32'
        one = EmotionEngine.from_models_dir(tmp.name, device='cuda',
                                            mesh=None)
        two = EmotionEngine.from_models_dir(tmp.name, device='cuda',
                                            mesh=['cuda:0', 'cuda:0'])
        errs32 = {}
        for B, (w, t, im) in inputs.items():
            _exact, errs32[B] = dp_scaling.replica_check(two, one, w, t, im)
        check(max(errs32.values()) <= SERVE_DP_TOL32,
              f'serve dp fp32: {errs32} > {SERVE_DP_TOL32}')
        print('serve dp fp32 (2 replicas sharing cuda:0): against mesh=None '
              'max|err| ' + ', '.join(f'B={B} {e:.3e}'
                                      for B, e in errs32.items())
              + f' <= {SERVE_DP_TOL32}; {card}')
        del one, two
    finally:
        Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = saved
        tmp.cleanup()
        torch.cuda.empty_cache()
    print(f'serve dp phase wall: {time.perf_counter() - t_phase:.1f} s; '
          f'{card}')
    return counts, len(inputs)


def axes_phase(card):
    """6e (training). Two gloo ranks sharing the card at BERT-base widths
    (12 x 768, 12 heads, 3072), seq 128, B=8, float64: tensor parallelism
    over model=2, with sequence parallelism, expert parallelism (an MoE
    BERT-base of 4 experts, 2 a rank) and a pipeline of 2 stages with 2
    microbatches; each layout's loss, clip norm and gradients after the
    reduce, gathered to the whole tree, against one process on the same
    batch within AXES_TOL of the largest gradient (bench/dp_scaling.
    layout_rank). Then train-text-bert --mesh-model 2 must refuse on one
    card, naming the visible GPU count."""
    import torch

    from mec_tpu_torch.bench import dp_scaling
    from mec_tpu_torch.parallel import launch
    t_phase = time.perf_counter()
    layouts = ['1x2x1', '1x2x1s', '1x2x1e4', '1x1x2']
    names = {'1x2x1': 'TP=2', '1x2x1s': 'TP=2 + SP', '1x2x1e4': 'EP (E=4 '
             'over 2)', '1x1x2': 'PP=2 (M=2)'}
    ranks = launch.launch(dp_scaling.layout_rank, 2,
                          args=(layouts, False, 0, False, 2),
                          devices=['cuda:0', 'cuda:0'], backend='gloo',
                          timeout=900)
    got = ranks[0]
    for spec in layouts:
        r = got[spec]
        check(max(r['grad_rel'], r['norm_rel'], r['loss_err']) <= AXES_TOL,
              f'axes {names[spec]}: {r} > {AXES_TOL}')
    print('axes (2 gloo ranks sharing cuda:0, BERT-base widths, seq 128, '
          'B=8, float64; gradients after the reduce gathered to the whole '
          'tree against one process): ' + '; '.join(
              f'{names[s]} max|err| {got[s]["grad_rel"]:.2e} of the largest '
              f'gradient ({got[s]["grad_max"]:.2e}), loss '
              f'{got[s]["loss_err"]:.2e}, clip norm {got[s]["norm_rel"]:.2e} '
              f'relative' for s in layouts) + f' <= {AXES_TOL}; {card}')
    cli = subprocess.run(
        [sys.executable, '-m', 'mec_tpu_torch', 'train-text-bert',
         '--mesh-model', '2', '--csv', 'none.csv', '--epochs', '1'],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    n_gpu = torch.cuda.device_count()
    check(cli.returncode != 0 and 'needs 2 GPUs' in cli.stderr
          and f'{n_gpu} is visible' in cli.stderr,
          f'train-text-bert --mesh-model 2 on {n_gpu} GPU did not refuse: '
          f'{cli.returncode} {cli.stderr[-1000:]}')
    print(f'axes cli: python -m mec_tpu_torch train-text-bert --mesh-model 2 '
          f'refused on {n_gpu} visible GPU: '
          f'{cli.stderr.strip().splitlines()[-1][:200]}; {card}')
    print(f'axes phase wall: {time.perf_counter() - t_phase:.1f} s; {card}')


# ----------------------------------------------------------------------
# phase 6f: the system's entry point — a reference-format directory
# converted at load and served over HTTP
# ----------------------------------------------------------------------
ENTRY_PACKAGES = ('jinja2', 'werkzeug', 'h5py', 'sklearn', 'joblib',
                  'safetensors')
HTTP_REPS = 20


def _lin(sd, pre, leaf):
    """A torch Linear's state from a Flax Dense leaf (kernel (in, out))."""
    sd[f'{pre}.weight'] = leaf['kernel'].T
    sd[f'{pre}.bias'] = leaf['bias']


def _ln(sd, pre, leaf):
    sd[f'{pre}.weight'], sd[f'{pre}.bias'] = leaf['scale'], leaf['bias']


def resnet_reference_state(tree):
    """The reference ImageEmotionModel's state dict (torchvision key names,
    base.fc.{1,4} head) of a Flax-layout ResNet50 tree."""
    p, s = tree['params'], tree['batch_stats']
    sd = {}

    def conv(pre, leaf):
        sd[f'{pre}.weight'] = leaf['kernel'].transpose(3, 2, 0, 1)  # OIHW

    def bn(pre, pl, sl):
        _ln(sd, pre, pl)
        sd[f'{pre}.running_mean'], sd[f'{pre}.running_var'] = \
            sl['mean'], sl['var']
        sd[f'{pre}.num_batches_tracked'] = np.zeros((), np.int64)

    conv('base.conv1', p['conv1'])
    bn('base.bn1', p['bn1'], s['bn1'])
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        for b in range(n_blocks):
            name, t = f'layer{stage + 1}_{b}', f'base.layer{stage + 1}.{b}'
            for i in (1, 2, 3):
                conv(f'{t}.conv{i}', p[name][f'conv{i}'])
                bn(f'{t}.bn{i}', p[name][f'bn{i}'], s[name][f'bn{i}'])
            if 'downsample_conv' in p[name]:
                conv(f'{t}.downsample.0', p[name]['downsample_conv'])
                bn(f'{t}.downsample.1', p[name]['downsample_bn'],
                   s[name]['downsample_bn'])
    _lin(sd, 'base.fc.1', p['fc1'])
    _lin(sd, 'base.fc.4', p['fc2'])
    return sd


def fusion_reference_state(tree):
    """The reference MultiModalFusionModel's state dict of a Flax-layout
    fusion tree (packed nn.MultiheadAttention in-projections)."""
    p, sd = tree['params'], {}

    def proj(pre, leaf):
        _lin(sd, f'{pre}.0', leaf['linear'])
        _ln(sd, f'{pre}.1', leaf['norm'])

    for mod in ('speech', 'text', 'image'):
        proj(f'{mod}_proj', p[f'{mod}_proj'])
        att = p[f'cross_attn_{mod}']['attention']
        pre = f'cross_attn_{mod}.attention'
        sd[f'{pre}.in_proj_weight'] = att['in_proj_weight']
        sd[f'{pre}.in_proj_bias'] = att['in_proj_bias']
        _lin(sd, f'{pre}.out_proj', att['out_proj'])
        _ln(sd, f'cross_attn_{mod}.norm', p[f'cross_attn_{mod}']['norm'])
    fus = p['attention_fusion']
    for i in range(3):
        proj(f'attention_fusion.projections.{i}', fus[f'proj_{i}'])
    _lin(sd, 'attention_fusion.attention.0', fus['attn_0'])
    _lin(sd, 'attention_fusion.attention.2', fus['attn_1'])
    for pre, key in (('decision_weights.0', 'decision_0'),
                     ('decision_weights.2', 'decision_1'),
                     ('classifier.0', 'classifier_0'),
                     ('classifier.4', 'classifier_1'),
                     ('classifier.7', 'classifier_2')):
        _lin(sd, pre, p[key])
    _ln(sd, 'classifier.1', p['classifier_norm'])
    return sd


def bert_reference_state(tree, num_layers):
    """A HuggingFace BertForSequenceClassification state dict (bert.*,
    classifier) of a Flax-layout BERT tree."""
    p, sd = tree['params'], {}
    for name in ('word', 'position', 'token_type'):
        sd[f'bert.embeddings.{name}_embeddings.weight'] = \
            p[f'{name}_embeddings']['embedding']
    _ln(sd, 'bert.embeddings.LayerNorm', p['embeddings_norm'])
    for i in range(num_layers):
        t, lay = f'bert.encoder.layer.{i}', p[f'layer_{i}']
        for k in ('query', 'key', 'value'):
            _lin(sd, f'{t}.attention.self.{k}', lay['attention_self'][k])
        _lin(sd, f'{t}.attention.output.dense', lay['attention_output'])
        _ln(sd, f'{t}.attention.output.LayerNorm', lay['attention_norm'])
        _lin(sd, f'{t}.intermediate.dense', lay['intermediate'])
        _lin(sd, f'{t}.output.dense', lay['output'])
        _ln(sd, f'{t}.output.LayerNorm', lay['output_norm'])
    _lin(sd, 'bert.pooler.dense', p['pooler'])
    _lin(sd, 'classifier', p['classifier'])
    return sd


def write_keras_speech_h5(path, tree):
    """speech_model.h5 in Keras's weight layout (model_weights/<layer>/
    <layer>/<weight>:0, layer_names in model order) with h5py."""
    import h5py
    p, s = tree['params'], tree['batch_stats']
    n = sum(1 for k in p if k.startswith('dense_') and k != 'dense_out')
    layers = []
    for i in range(n):
        layers.append((f'dense_{i}', {'kernel': p[f'dense_{i}']['kernel'],
                                      'bias': p[f'dense_{i}']['bias']}))
        layers.append((f'batch_normalization_{i}', {
            'gamma': p[f'bn_{i}']['scale'], 'beta': p[f'bn_{i}']['bias'],
            'moving_mean': s[f'bn_{i}']['mean'],
            'moving_variance': s[f'bn_{i}']['var']}))
    layers.append((f'dense_{n}', {'kernel': p['dense_out']['kernel'],
                                  'bias': p['dense_out']['bias']}))
    with h5py.File(path, 'w') as f:
        g = f.create_group('model_weights')
        for lname, ws in layers:
            for w, a in ws.items():
                g.create_dataset(f'{lname}/{lname}/{w}:0', data=a)
        g.attrs['layer_names'] = np.array([n.encode() for n, _ in layers])


def same_tree(a, b):
    """Leaf for leaf equal (keys, dtypes, shapes, values)."""
    if isinstance(b, dict):
        return (isinstance(a, dict) and sorted(a) == sorted(b)
                and all(same_tree(a[k], b[k]) for k in b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and bool(np.array_equal(a, b))


def write_reference_dir(d, have):
    """A full-width models directory in the reference's formats, from the
    port's synthetic trees (numpy seeds): image_model.pt (ResNet50),
    fusion_model.pt, bert_model/ (HF BERT-base: pytorch_model.bin, and
    model.safetensors where safetensors is present, config.json,
    vocab.txt); the speech DNN as speech_model.h5 with speech_scaler.pkl
    where h5py and sklearn are present, else its .mecp and .npz; a
    fitted forest .pkl where sklearn is present. Returns the trees."""
    import torch

    from mec_tpu_torch.convert import store
    from mec_tpu_torch.serving.synthetic_artifacts import (bert_variables,
                                                           fusion_variables,
                                                           image_variables,
                                                           make_vocab,
                                                           speech_variables)

    def tensors(sd):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}

    trees = {'image': image_variables(seed=IMAGE_SEED)[0],
             'fusion': fusion_variables(seed=FUSION_SEED),
             'bert': bert_variables(seed=BERT_SEED),
             'speech': speech_variables(seed=2)}
    torch.save(tensors(resnet_reference_state(trees['image'])),
               os.path.join(d, 'image_model.pt'))
    fp = trees['fusion']['params']
    torch.save({'model_state_dict': tensors(fusion_reference_state(
        trees['fusion'])), 'config': {
            **{f'{m}_dim': int(fp[f'{m}_proj']['linear']['kernel'].shape[0])
               for m in ('speech', 'text', 'image')},
            'num_classes': int(fp['classifier_2']['kernel'].shape[1]),
            'hidden_dim': int(fp['speech_proj']['linear']['kernel']
                              .shape[1])}},
        os.path.join(d, 'fusion_model.pt'))
    bert_dir = os.path.join(d, 'bert_model')
    os.makedirs(bert_dir)
    bp = trees['bert']['params']
    vocab_rows, hidden = bp['word_embeddings']['embedding'].shape
    layers = sum(1 for k in bp if k.startswith('layer_'))
    sd = tensors(bert_reference_state(trees['bert'], layers))
    torch.save(sd, os.path.join(bert_dir, 'pytorch_model.bin'))
    if have['safetensors']:
        from safetensors.torch import save_file
        save_file(sd, os.path.join(bert_dir, 'model.safetensors'))
    with open(os.path.join(bert_dir, 'config.json'), 'w') as f:
        json.dump({'vocab_size': vocab_rows, 'hidden_size': hidden,
                   'num_hidden_layers': layers,
                   'num_attention_heads': hidden // 64,
                   'intermediate_size':
                       bp['layer_0']['intermediate']['kernel'].shape[1],
                   'max_position_embeddings':
                       bp['position_embeddings']['embedding'].shape[0],
                   'type_vocab_size':
                       bp['token_type_embeddings']['embedding'].shape[0],
                   'num_labels': bp['classifier']['kernel'].shape[1]}, f)
    vocab = make_vocab()
    with open(os.path.join(bert_dir, 'vocab.txt'), 'w') as f:
        f.write('\n'.join(sorted(vocab, key=vocab.get)) + '\n')
    # the speech scaler fitted to seeded clips' features, as the trainer
    # fits it (bench/dp_scaling.fit_speech_scaler says why)
    from mec_tpu_torch.ops import audio_features as af
    feats = af.audio_features_56(torch.from_numpy(waves(32, 97)),
                                 'parity').numpy()
    mean, scale = feats.mean(0), feats.std(0) + 1e-6
    trees['scaler'] = (mean, scale)
    if have['h5py'] and have['sklearn']:
        import joblib
        from sklearn.preprocessing import StandardScaler
        write_keras_speech_h5(os.path.join(d, 'speech_model.h5'),
                              trees['speech'])
        scaler = StandardScaler().fit(feats)
        scaler.mean_, scaler.scale_ = mean, scale
        joblib.dump(scaler, os.path.join(d, 'speech_scaler.pkl'))
    else:
        store.save_params(os.path.join(d, 'speech_model.mecp'),
                          trees['speech'])
        np.savez(os.path.join(d, 'speech_scaler.npz'), mean=mean,
                 scale=scale)
    if have['sklearn']:
        import joblib
        from sklearn.ensemble import RandomForestClassifier
        rng = np.random.RandomState(11)
        x = rng.dirichlet(np.ones(7), (200, 3)).reshape(200, 21)
        joblib.dump(RandomForestClassifier(n_estimators=4, max_depth=4,
                                           random_state=0).fit(
            x.astype(np.float32), x.reshape(200, 3, 7).sum(1).argmax(1)),
            os.path.join(d, 'fusion_rf.pkl'))
    return trees


def multipart(fields, files):
    """multipart/form-data body and content type for urllib."""
    boundary = 'chipsmoke' + os.urandom(8).hex()
    out = []
    for name, value in fields.items():
        out += [f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="{name}"\r\n\r\n'.encode(), value.encode(), b'\r\n']
    for name, path in files.items():
        with open(path, 'rb') as f:
            data = f.read()
        out += [f'--{boundary}\r\nContent-Disposition: form-data; '
                f'name="{name}"; filename="{os.path.basename(path)}"\r\n'
                f'Content-Type: application/octet-stream\r\n\r\n'.encode(),
                data, b'\r\n']
    out.append(f'--{boundary}--\r\n'.encode())
    return b''.join(out), f'multipart/form-data; boundary={boundary}'


def http_call(opener, url, *, json_body=None, fields=None, files=None,
              method=None):
    """(status, parsed JSON) of one request through urllib."""
    import urllib.error
    import urllib.request
    if json_body is not None:
        data, ctype = json.dumps(json_body).encode(), 'application/json'
    elif fields is not None or files is not None:
        data, ctype = multipart(fields or {}, files or {})
    else:
        data, ctype = None, None
    req = urllib.request.Request(url, data=data, method=method)
    if ctype:
        req.add_header('Content-Type', ctype)
    try:
        with opener.open(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode('utf-8', 'replace')


def check_answer(got, what):
    """An HTTP prediction: one of the 7 emotions, probabilities that sum
    to 1 within 1e-5, no engine-internal keys."""
    from mec_tpu_torch.config import Config
    check(set(got) == {'emotion', 'confidence', 'all_probabilities'},
          f'{what}: answer keys {sorted(got)}')
    p = np.asarray(got['all_probabilities'])
    check(got['emotion'] in Config.EMOTIONS and p.shape == (7,)
          and bool(np.isfinite(p).all()) and abs(p.sum() - 1.0) <= 1e-5,
          f'{what}: answer {got}')


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def entry_phase(card, wrappers, tri_waves, tri_pics, device='cuda'):
    """6f. The system's entry point: a full-width reference-format
    directory converted at load (get_engine in bf16: each .mecp written
    beside its artifact), a second from_models_dir reading the caches
    with every converter replaced by one that fails (tri-modal rows at
    B=1, 8 bit for bit the first engine's; within TRI_BAND of the cpu
    engine on the same directory), the port's create_app on werkzeug's
    make_server in a thread: register, the four prediction routes over
    urllib, 8 concurrent tri-modal requests, /api/predictions, launch
    counters, 20 sequential b1 tri-modal requests timed; the serve CLI as
    a subprocess answering one request; the kernel switches' counters
    and a .env read by a fresh interpreter. Returns (launch counts over
    the HTTP tri-modal requests, their tri-modal dispatches)."""
    import http.cookiejar
    import importlib.util
    import urllib.request

    from PIL import Image

    from mec_tpu_torch.config import Config
    from mec_tpu_torch.convert import (hf_bert, keras_h5, sklearn_rf, store,
                                       torch_pt)
    from mec_tpu_torch.database import Database
    from mec_tpu_torch.ops import wav
    from mec_tpu_torch.serving import engine as engine_module
    from mec_tpu_torch.serving.engine import EmotionEngine, get_engine
    t_phase = time.perf_counter()

    # 1. the host packages
    have = {m: importlib.util.find_spec(m) is not None
            for m in ENTRY_PACKAGES}
    print('entry: host packages (find_spec): ' + ', '.join(
        f'{m} {"present" if v else "absent"}' for m, v in have.items()))
    check(have['werkzeug'], 'the HTTP front door needs werkzeug')

    # 2. a reference-format directory from seeds
    tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_entry_')
    d = os.path.join(tmp.name, 'models')
    os.makedirs(d)
    t0 = time.perf_counter()
    trees = write_reference_dir(d, have)
    print(f'entry: reference-format directory written in '
          f'{time.perf_counter() - t0:.2f} s: ' + ', '.join(sorted(
              os.path.relpath(os.path.join(r, f), d)
              for r, _d, fs in os.walk(d) for f in fs)))
    if not have['h5py']:
        try:
            keras_h5.convert_speech_h5(os.path.join(d, 'speech_model.h5'))
            fail('convert_speech_h5 ran without h5py')
        except ImportError as e:
            check('h5py' in str(e), f'the ImportError names no h5py: {e}')
            print(f'entry: without h5py, convert_speech_h5 raises '
                  f'ImportError: {e}')
    if not have['joblib']:
        try:
            sklearn_rf.convert_fusion_rf(os.path.join(d, 'fusion_rf.pkl'))
            fail('convert_fusion_rf ran without joblib')
        except ImportError as e:
            check('joblib' in str(e), f'the ImportError names no joblib: {e}')

    # 3. convert at load, then serve from the caches
    saved = (Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION,
             Config.UPLOAD_FOLDER, Config.LOG_DIR)
    Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = \
        'attention', 'bfloat16', 'high'
    Config.UPLOAD_FOLDER = os.path.join(tmp.name, 'uploads')
    Config.LOG_DIR = os.path.join(tmp.name, 'logs')
    server = app = None
    try:
        before = {os.path.relpath(os.path.join(r, f), d)
                  for r, _d, fs in os.walk(d) for f in fs}
        t0 = time.perf_counter()
        eng = get_engine(d, reload=True, device=device)
        load_convert = time.perf_counter() - t0
        written = sorted({os.path.relpath(os.path.join(r, f), d)
                          for r, _d, fs in os.walk(d) for f in fs} - before)
        want = ['bert_model/bert_model.mecp', 'fusion_model.mecp',
                'image_model.mecp'] + (['speech_model.mecp',
                                        'speech_scaler.npz']
                                       if have['h5py'] and have['sklearn']
                                       else [])
        check(written == sorted(want), f'conversion wrote {written}, '
              f'want {sorted(want)}')
        check(eng.device.type == device and eng._all_live
              and eng._fusion_kind == 'attention'
              and eng._image_arch == 'resnet50'
              and eng._image_quant_mode == eng._bert_quant_mode == 'static'
              and eng._compress, 'get_engine did not build the bf16 '
              'int8-static tri-modal engine on the card')
        for name, key in (('image_model.mecp', 'image'),
                          ('fusion_model.mecp', 'fusion'),
                          ('bert_model/bert_model.mecp', 'bert')):
            check(same_tree(store.load_params(os.path.join(d, name))
                            ['variables'], trees[key]),
                  f'{name}: the converted tree is not the seed tree')
        t0 = time.perf_counter()
        eng.warmup((1, 8, 32))
        warm = time.perf_counter() - t0
        refuse_calls = []

        def refuse(*_a, **_k):
            refuse_calls.append(1)
            raise RuntimeError('a converter ran on a cached directory')

        converters = [(mod, name) for mod, names in (
            (keras_h5, ('convert_speech_h5', 'load_sklearn_scaler',
                        'convert_lstm_text_h5')),
            (torch_pt, ('convert_image_pt', 'convert_fusion_pt',
                        'fusion_config_from_pt')),
            (hf_bert, ('convert_bert_dir',)),
            (sklearn_rf, ('convert_fusion_rf',))) for name in names]
        real = {(m, n): getattr(m, n) for m, n in converters}
        for m, n in converters:
            setattr(m, n, refuse)
        try:
            t0 = time.perf_counter()
            cached = EmotionEngine.from_models_dir(d, device=device)
            load_cached = time.perf_counter() - t0
        finally:
            for (m, n), fn in real.items():
                setattr(m, n, fn)
        check(not refuse_calls and cached._image_scales_cached
              and cached._bert_scales_cached, 'the second load converted '
              'or recalibrated')
        print(f'entry: load wall {load_convert:.2f} s converting (.pt, HF '
              f'BERT{", .h5, .pkl" if have["h5py"] else ""}) and '
              f'calibrating, {load_cached:.2f} s from the caches; warmup '
              f'(1, 8, 32) {warm:.2f} s; {card}')
        texts8 = TEXTS[:8]
        for B in (1, 8):
            a = eng._run_trimodal(tri_waves[:B], texts8[:B], tri_pics[:B])
            b = cached._run_trimodal(tri_waves[:B], texts8[:B], tri_pics[:B])
            check(a.shape == (B, 34) and np.array_equal(a, b),
                  f'B={B}: the cached engine\'s rows differ from the '
                  f'converting engine\'s')
        del cached
        cpu = EmotionEngine.from_models_dir(d, device='cpu')
        check(cpu._image_scales_cached and cpu._bert_scales_cached,
              'the cpu engine did not take the card\'s scales')
        k_rows = eng._run_trimodal(tri_waves[:8], texts8, tri_pics[:8])
        c_rows = cpu._run_trimodal(tri_waves[:8], texts8, tri_pics[:8])
        e_cpu = float(np.abs(k_rows - c_rows).max())
        check(e_cpu <= TRI_BAND, f'converted directory: card against cpu '
              f'{e_cpu} > {TRI_BAND}')
        for row_k, row_c in zip(k_rows, c_rows):
            for lo in (0, 7, 14, 21):
                top2 = np.sort(row_c[lo:lo + 7])[-2:]
                check(top2[1] - top2[0] <= TRI_BAND
                      or np.argmax(row_k[lo:lo + 7])
                      == np.argmax(row_c[lo:lo + 7]),
                      'converted directory: a decision differs from cpu')
        del cpu
        print(f'entry: cached engine bit for bit the converting one at '
              f'B=1, 8; card against cpu (34 packed values, B=8) '
              f'{e_cpu:.3e} <= {TRI_BAND}')

        # 4. HTTP in this process (werkzeug's per-request log lines off)
        import logging

        from werkzeug.serving import make_server
        logging.getLogger('werkzeug').setLevel(logging.WARNING)

        from mec_tpu_torch.webapp.app import create_app
        files = []
        for i in range(8):
            wp = os.path.join(tmp.name, f'req{i}.wav')
            pp = os.path.join(tmp.name, f'req{i}.png')
            wav.write_wav(wp, tri_waves[i + 1], 22050)
            Image.fromarray(tri_pics[i + 1]).save(pp)
            files.append((wp, TEXTS[i], pp))
        app = create_app(db=Database(os.path.join(tmp.name, 'web.db')),
                         models_dir=d, device=device)
        check(app.engine is eng, 'create_app did not take get_engine\'s '
              'engine')
        server = make_server('127.0.0.1', 0, app, threaded=True)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f'http://127.0.0.1:{server.server_port}'
        opener = urllib.request.build_opener(
            urllib.request.HTTPCookieProcessor(http.cookiejar.CookieJar()))
        status, body = http_call(opener, base + '/api/register', json_body={
            'username': 'chipsmoke', 'email': 'chip@example.com',
            'password': 'password123'})
        check(status == 201, f'/api/register: {status} {body}')
        for w in wrappers.values():
            w.launches = 0
        wp, text, pp = files[0]
        t0 = time.perf_counter()
        status, tri_first = http_call(opener, base + '/api/predict/multimodal',
                                 fields={'text': text},
                                 files={'audio': wp, 'image': pp})
        first_ms = (time.perf_counter() - t0) * 1e3
        check(status == 200, f'/api/predict/multimodal: {status}')
        answers = {
            'speech': http_call(opener, base + '/api/predict/speech',
                           files={'audio': wp}),
            'text': http_call(opener, base + '/api/predict/text',
                         json_body={'text': text}),
            'image': http_call(opener, base + '/api/predict/image',
                          files={'image': pp})}
        counts = {n: w.launches for n, w in wrappers.items()}
        stats = app.batcher.stats()
        want = {'speech': eng.predict_speech_paths([wp])[0],
                'text': eng.predict_texts([text])[0],
                'image': eng.predict_image_paths([pp])[0]}
        ref = eng.predict_multimodal(audio_path=wp, text=text, image_path=pp)
        for mod, (status, body) in answers.items():
            check(status == 200, f'/api/predict/{mod}: {status} {body}')
            check_answer(body, f'/api/predict/{mod}')
            check_results([body], [want[mod]], TRI_BAND,
                          f'HTTP {mod} against the engine')
        check(set(tri_first) == {'speech', 'text', 'image', 'fusion'},
              f'tri-modal answer {sorted(tri_first)}')
        for mod in ('speech', 'text', 'image'):
            check_answer(tri_first[mod], f'tri-modal {mod}')
        for mod in tri_first:
            check_results([tri_first[mod]], [ref[mod]], TRI_BAND,
                          f'HTTP tri-modal {mod} against the engine')
        s_n = stats['speech']['batches']
        i_n = stats['image']['batches']
        m_n = stats['multimodal']['batches']
        check((s_n, i_n, m_n) == (1, 1, 1), f'batches {stats}')
        for n, c in counts.items():
            want_n = (0 if n == 'dft_spectrograms'
                      else m_n + (s_n if n in ('mfcc_mean', 'tuning_select',
                                               'rolloff_bins', 'speech_dnn')
                                  else i_n))
            check(c == want_n, f'{n} launched {c} times over the four '
                  f'routes (want {want_n})')
        # 8 concurrent tri-modal requests from 8 threads, then 20 at b1
        for w in wrappers.values():
            w.launches = 0
        m_before = app.batcher.stats()['multimodal']['batches']
        served = [None] * 8

        def one(i):
            wp, text, pp = files[i]
            served[i] = http_call(opener, base + '/api/predict/multimodal',
                             fields={'text': text},
                             files={'audio': wp, 'image': pp})

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        check(all(s is not None and s[0] == 200 for s in served),
              f'concurrent tri-modal requests: {[s and s[0] for s in served]}')
        coalesced = app.batcher.stats()['multimodal']['batches'] - m_before
        walls = []
        for i in range(HTTP_REPS):
            wp, text, pp = files[i % 8]
            t0 = time.perf_counter()
            status, body = http_call(opener, base + '/api/predict/multimodal',
                                fields={'text': text},
                                files={'audio': wp, 'image': pp})
            walls.append((time.perf_counter() - t0) * 1e3)
            check(status == 200, f'sequential tri-modal request: {status}')
        dispatches = app.batcher.stats()['multimodal']['batches'] - m_before
        http_counts = {n: w.launches for n, w in wrappers.items()}
        for n, c in http_counts.items():
            want_n = 0 if n == 'dft_spectrograms' else dispatches
            check(c == want_n, f'{n} launched {c} times in {dispatches} '
                  f'HTTP tri-modal dispatches (want {want_n})')
        refs = eng.predict_multimodal_batch(
            [{'audio_path': wp, 'text': text, 'image_path': pp}
             for wp, text, pp in files])
        for (status, body), r in zip(served, refs):
            for mod in body:
                check_results([body[mod]], [r[mod]], TRI_BAND,
                              f'HTTP concurrent tri-modal {mod}')
        status, rows = http_call(opener, base + '/api/predictions')
        n_req = 4 + 8 + HTTP_REPS
        check(status == 200 and len(rows) == n_req,
              f'/api/predictions: {status}, {len(rows)} rows for {n_req} '
              f'requests')
        walls.sort()
        print(f'entry: HTTP (werkzeug make_server, urllib): register, the '
              f'four prediction routes within {TRI_BAND} of the engine, '
              f'8 concurrent tri-modal requests in {coalesced} batch(es), '
              f'{len(rows)} rows in /api/predictions; launches '
              f'{http_counts} in {dispatches} tri-modal dispatches (K5 '
              f'never)')
        print(f'time HTTP /api/predict/multimodal B=1: first request '
              f'{first_ms:.2f} ms; {HTTP_REPS} sequential requests p50 '
              f'{statistics.median(walls):.2f} ms, p99 '
              f'{walls[int(np.ceil(0.99 * len(walls))) - 1]:.2f} ms, min '
              f'{walls[0]:.2f} ms (host wall around urllib: multipart '
              f'upload, save, decode, batcher, device step, JSON, sqlite '
              f'record); {card}')
    finally:
        if server is not None:
            server.shutdown()
        if app is not None and app._batcher is not None:
            app._batcher.stop()
        (Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION,
         Config.UPLOAD_FOLDER, Config.LOG_DIR) = saved
        engine_module._engine = None

    # 5. the CLI once, as a subprocess
    port = free_port()
    env = dict(os.environ, MEC_COMPUTE_DTYPE='bfloat16', MEC_SKIP_DOTENV='1',
               DATABASE_URL='sqlite:///' + os.path.join(tmp.name, 'cli.db'),
               UPLOAD_FOLDER=os.path.join(tmp.name, 'cli_uploads'),
               MEC_LOG_DIR=os.path.join(tmp.name, 'cli_logs'),
               PYTHONPATH=HERE)
    cli_log = os.path.join(tmp.name, 'serve_cli.log')
    t0 = time.perf_counter()
    with open(cli_log, 'w') as log_f:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'mec_tpu_torch', 'serve', '--models-dir',
             d, '--host', '127.0.0.1', '--port', str(port), '--device',
             device, '--warmup'], cwd=HERE, env=env, stdout=log_f,
            stderr=subprocess.STDOUT)
    try:
        import socket
        up = False
        while time.perf_counter() - t0 < 300 and proc.poll() is None:
            with socket.socket() as s:
                if s.connect_ex(('127.0.0.1', port)) == 0:
                    up = True
                    break
            time.sleep(0.5)
        check(up, f'the serve CLI did not listen (exit {proc.poll()})')
        up_s = time.perf_counter() - t0
        wp, text, pp = files[0]
        status, body = http_call(urllib.request.build_opener(),
                            f'http://127.0.0.1:{port}/api/predict/multimodal',
                            fields={'text': text},
                            files={'audio': wp, 'image': pp})
        check(status == 200 and set(body) == {'speech', 'text', 'image',
                                              'fusion'},
              f'the serve CLI answered {status} {body}')
        for mod in ('speech', 'text', 'image'):
            check_answer(body[mod], f'CLI tri-modal {mod}')
        check(proc.poll() is None, f'the serve CLI exited {proc.poll()}')
    finally:
        if proc.poll() is None:
            proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    with open(cli_log) as f:
        out = f.read()
    check(proc.returncode == -15, f'the serve CLI ended with '
          f'{proc.returncode} (not by the terminate):\n{out[-3000:]}')
    print(f'entry: python -m mec_tpu_torch serve --device {device} '
          f'--warmup '
          f'listened after {up_s:.1f} s, answered one tri-modal request, '
          f'ended by SIGTERM')

    # 6. the kernel switches and a .env
    clips = waves(5, seed=31)
    for flag, off in (('USE_PALLAS', ('mfcc_mean', 'rolloff_bins',
                                      'speech_dnn', 'dft_spectrograms')),
                      ('PALLAS_TUNING', ('tuning_select',)),
                      ('PALLAS_ROLLOFF', ('rolloff_bins',))):
        old = getattr(Config, flag)
        setattr(Config, flag, False)
        try:
            k_eng = EmotionEngine(trees['speech'], trees['scaler'],
                                  compute_dtype='bfloat16', device=device)
            c_eng = EmotionEngine(trees['speech'], trees['scaler'],
                                  compute_dtype='bfloat16', device='cpu')
            for w in wrappers.values():
                w.launches = 0
            got = k_eng.predict_speech_waves(clips)
            counts = {n: w.launches for n, w in wrappers.items()}
            ref = c_eng.predict_speech_waves(clips)
        finally:
            setattr(Config, flag, old)
        for n, c in counts.items():
            want_n = 0 if n in off or n in ('dft_spectrograms',
                                            'max_pool_3x3s2', 'layer1') else 1
            check(c == want_n, f'MEC_{flag}=0: {n} launched {c} times in '
                  f'one speech dispatch (want {want_n})')
        worst = check_results(got, ref, SPEECH_BAND, f'MEC_{flag}=0 speech')
        print(f'entry: MEC_{flag}=0 bf16 speech engine: launches {counts} '
              f'in one dispatch; against device=cpu {worst:.3e} <= '
              f'{SPEECH_BAND}')
    env_dir = os.path.join(tmp.name, 'dotenv')
    os.makedirs(env_dir)
    with open(os.path.join(env_dir, '.env'), 'w') as f:
        f.write('MEC_COMPUTE_DTYPE=bfloat16\nexport MEC_USE_PALLAS=0\n')
    env = {k: v for k, v in os.environ.items()
           if k not in ('MEC_COMPUTE_DTYPE', 'MEC_USE_PALLAS',
                        'MEC_SKIP_DOTENV')}
    env['PYTHONPATH'] = HERE
    r = subprocess.run([sys.executable, '-c', 'import mec_tpu_torch.config '
                        'as c; print(c.Config.COMPUTE_DTYPE, '
                        'c.Config.USE_PALLAS)'], cwd=env_dir, env=env,
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 0 and r.stdout.split() == ['bfloat16', 'False'],
          f'.env not loaded: {r.stdout} {r.stderr[-2000:]}')
    print('entry: a fresh interpreter in a directory with a .env reads '
          'MEC_COMPUTE_DTYPE=bfloat16 and MEC_USE_PALLAS=0 from it')
    tmp.cleanup()
    print(f'entry phase wall: {time.perf_counter() - t_phase:.1f} s; {card}')
    return http_counts, dispatches


# ----------------------------------------------------------------------
# phase 6g: the native host runtime and the host audio features
# ----------------------------------------------------------------------
def host_ms(fn, reps):
    """Median host-clock milliseconds of fn() over reps calls, after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def in_turns(fns, reps):
    """{name: median ms} of host-clock timings of each fn, taken in turns
    (a, b, b, a for two) so drift hits all alike; each leg reps calls."""
    order = list(fns) + list(reversed(list(fns)))
    legs = {name: [] for name in fns}
    for name in order:
        legs[name].append(host_ms(fns[name], reps))
    return {name: statistics.median(v) for name, v in legs.items()}


def cpu_model():
    """The host CPU's model name: /proc/cpuinfo's, else lscpu's (a
    virtualised host may report 'unknown' in both), else the machine
    type."""
    import platform
    lines = []
    try:
        with open('/proc/cpuinfo', encoding='utf-8', errors='replace') as f:
            lines += [ln for ln in f if ln.startswith('model name')]
    except OSError:
        pass
    try:
        lines += [ln for ln in subprocess.run(
            ['lscpu'], capture_output=True, text=True,
            timeout=30).stdout.splitlines() if ln.startswith('Model name:')]
    except (OSError, subprocess.TimeoutExpired):
        pass
    for ln in lines:
        name = ln.split(':', 1)[1].strip()
        if name and name.lower() != 'unknown':
            return name
    return f'CPU model not reported ({platform.machine()})'


def contract_clips():
    """The six clips of the host-features contract
    (tests/test_host_features.py:24-36): a tone, a chord, noise,
    silence, a tone in noise, a clipped burst."""
    rng = np.random.RandomState(0)
    t = np.arange(N) / 22050
    return np.stack([
        0.1 * np.sin(2 * np.pi * 330 * t),
        0.05 * np.sin(2 * np.pi * 261.63 * t)
        + 0.02 * np.sin(2 * np.pi * 523.25 * t),
        rng.randn(N) * 0.05,
        np.zeros(N),
        rng.randn(N) * 0.02 + 0.05 * np.sin(2 * np.pi * 440 * t),
        np.clip(rng.randn(N) * 0.4, -1, 1),
    ]).astype(np.float32)


def host_phase(card, wrappers, speech_tree, scaler, tri_engine, bert_meta,
               wave_tri, wave_speech, requests, tri_waves, tri_pics):
    """6g (host). The native host libraries built with g++ from the
    checkout (all three must load); at full width the C++ encoders and
    the WordPiece encoder against their numpy and Python versions, and
    the C++ featurizer against features_56_np; a bf16 speech engine and
    a full-width tri-modal engine (phase 6's trees and scales) with
    MEC_HOST_AUDIO_FEATURES=1, warmed up (1, 8, 32) and predicting B=1,
    5, 32: K4 once a dispatch (and K6, K7 tri-modal), K1, K2, K3, K5
    never; each within SPEECH_BAND or TRI_BAND of the same engine on
    device='cpu'; preprocess_audio on a WAV on the card (K2 once, within
    the parity contract of device='cpu'); then the host timings (encoders,
    tokenizer, featurizer beside the speech device step, and the two
    audio wires of the tri-modal request in turns). Returns (launch
    counts, dispatches) of the host-feature engines."""
    import torch

    from mec_tpu_torch import native
    from mec_tpu_torch.config import Config
    from mec_tpu_torch.native import featurizer
    from mec_tpu_torch.native.tokenizer import accelerate
    from mec_tpu_torch.ops import audio_features as af
    from mec_tpu_torch.ops import host_features
    from mec_tpu_torch.preprocessing.audio_preprocessing import \
        preprocess_audio
    from mec_tpu_torch.serving import wire
    from mec_tpu_torch.serving.engine import EmotionEngine
    from mec_tpu_torch.serving.synthetic_artifacts import make_vocab
    from mec_tpu_torch.text.wordpiece import WordPieceTokenizer
    t_phase = time.perf_counter()
    host = f'{cpu_model()}, os.cpu_count() {os.cpu_count()}'
    t0 = time.perf_counter()
    status = native.status()
    print(f'host: native.status() {status} (g++ build and load '
          f'{time.perf_counter() - t0:.2f} s); {host}')
    check(all(status.values()), f'native libraries not all loaded: {status}')
    saved = Config.HOST_AUDIO_FEATURES
    try:
        Config.HOST_AUDIO_FEATURES = 'auto'
        auto = EmotionEngine(compute_dtype='bfloat16', device='cpu')
        print(f"host: MEC_HOST_AUDIO_FEATURES=auto resolves to "
              f"{'on' if auto._host_audio else 'off'} on this host "
              f"({os.cpu_count()} CPUs, C++ featurizer "
              f"{featurizer.have_native()})")
        Config.HOST_AUDIO_FEATURES = '1'
        speech = EmotionEngine(speech_tree, scaler, compute_dtype='bfloat16',
                               device='cuda')
        speech_cpu = EmotionEngine(speech_tree, scaler,
                                   compute_dtype='bfloat16', device='cpu')
        tri = tri_engine('cuda', 'bfloat16', 'high', bert_meta)
        tri_cpu = tri_engine('cpu', 'bfloat16', 'high', bert_meta)
    finally:
        Config.HOST_AUDIO_FEATURES = saved
    check(speech._host_audio and tri._host_audio and tri._all_live
          and tri._bert_scales_cached and tri._image_scales_cached
          and tri_cpu._bert_scales_cached and tri_cpu._image_scales_cached,
          'host-feature engines: flag not on, or the card\'s scales not '
          'taken')

    # the libraries against their numpy and Python versions, full width
    clips = waves(32, seed=11)
    pics = images(32, seed=12)
    texts = [(' '.join(TEXTS) + ' ') * (1 + i % 4) for i in range(32)]
    got = wire.encode_pcm12(clips)
    for g, w in zip(got, wire.encode_pcm12_np(clips)):
        check(g.dtype == w.dtype and np.array_equal(g, w),
              'encode_pcm12: native bytes differ from numpy')
    (y8, uv8), (ny, nuv) = wire.encode_yuv420(pics), wire.encode_yuv420_np(pics)
    uv_err = int(np.abs(uv8.astype(int) - nuv.astype(int)).max())
    check(np.array_equal(y8, ny) and uv_err <= 1,
          f'encode_yuv420: Y differs or UV off numpy by {uv_err} > 1 code')
    tok = WordPieceTokenizer(make_vocab())
    py_ids, py_mask = tok.encode_batch(texts, 128)
    check(accelerate(tok), 'accelerate() did not take the native encoder')
    n_ids, n_mask = tok.encode_batch(texts, 128)
    check(np.array_equal(n_ids, py_ids) and np.array_equal(n_mask, py_mask),
          'native WordPiece ids or mask differ from Python')
    print(f'host: B=32 full width: encode_pcm12 native bytes = numpy; '
          f'encode_yuv420 Y = numpy, UV within {uv_err} code; WordPiece '
          f'(32 texts, max_length 128) ids and mask = Python')

    def feature_err(got, ref):
        d = np.abs(got - ref)
        return (d[:, :40].max(axis=1), d[:, 40:52].max(axis=1),
                (d[:, 52:] / (np.abs(ref[:, 52:]) + 1.0)).max(axis=1))

    # the original's contract (tests/test_host_features.py:83-87) on its
    # six clips; on the seeded clips MFCC and the spectral scalars too,
    # while chroma follows each path's tuning estimate, whose histogram
    # has near-ties on noise (ROADMAP C4): rows beyond 1e-3 are counted,
    # against the numpy mirror and against the card's parity frontend
    six = contract_clips()
    mfcc, chroma, spectral = feature_err(featurizer.extract56(six),
                                         host_features.features_56_np(six))
    check(mfcc.max() < 1e-2 and chroma.max() < 1e-3 and spectral.max() < 1e-3,
          f'extract56 against features_56_np on the six contract clips '
          f'(mfcc, chroma, spectral rel): {mfcc.max()}, {chroma.max()}, '
          f'{spectral.max()}')
    nat = featurizer.extract56(clips)
    mfcc, chroma, spectral = feature_err(nat,
                                         host_features.features_56_np(clips))
    check(mfcc.max() < 1e-2 and spectral.max() < 1e-3,
          f'extract56 against features_56_np at B=32: mfcc {mfcc.max()}, '
          f'spectral rel {spectral.max()}')
    with torch.inference_mode():
        dev = af.audio_features_56(torch.from_numpy(clips).cuda(),
                                   'parity').cpu().numpy()
    _m, chroma_dev, _s = feature_err(nat, dev)
    print(f'host: extract56 on the six contract clips within the original\'s '
          f'contract; at B=32 against features_56_np: mfcc '
          f'{mfcc.max():.3e} (< 1e-2), spectral rel {spectral.max():.3e} '
          f'(< 1e-3), chroma {chroma.max():.3e} with '
          f'{int((chroma > 1e-3).sum())} of 32 rows beyond 1e-3; against '
          f'the card\'s parity frontend chroma {chroma_dev.max():.3e} with '
          f'{int((chroma_dev > 1e-3).sum())} rows beyond 1e-3 (tuning '
          f'near-ties)')

    # the host-feature engines on the card: K4 (+ K6, K7) alone
    def counts_after(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        return out, {name: w.launches for name, w in wrappers.items()}

    def want_only(counts, names, n, what):
        for name, got in counts.items():
            want = n if name in names else 0
            check(got == want, f'{what}: {name} launched {got} times '
                  f'(want {want})')

    results, c_speech = counts_after(lambda: (
        speech.warmup((1, 8, 32)),
        {B: speech.predict_speech_waves(clips[:B], want_features=True)
         for B in (1, 5, 32)})[1])
    want_only(c_speech, ('speech_dnn',), 6, 'host-feature speech engine '
              '(3 warmup, 3 predict dispatches)')
    check(speech._wire_waves(clips[:5], 8)[0].shape == (8, 56),
          'host-feature speech wire is not (bucket, 56)')
    worst = 0.0
    for B in (1, 5, 32):
        ref = speech_cpu.predict_speech_waves(clips[:B], want_features=True)
        worst = max(worst, check_results(results[B], ref, SPEECH_BAND,
                                         f'host-feature speech B={B}'))
        worst = max(worst, max(float(np.abs(g['_features'] - r['_features'])
                                     .max()) for g, r in zip(results[B], ref)))
    check(worst <= SPEECH_BAND, f'host-feature speech penult {worst}')
    print(f'host: bf16 speech engine (host features): 6 dispatches, '
          f'launches {c_speech}; probs and penult against device=cpu '
          f'max|err| {worst:.3e} <= {SPEECH_BAND}')

    seqs = sorted({s for s in Config.SEQ_BUCKETS
                   if s < Config.MAX_TEXT_LENGTH} | {Config.MAX_TEXT_LENGTH})
    batch_reqs = {B: [{'audio_path': f'{i}.wav', 'text': (TEXTS * 8)[i],
                       'image_path': f'{i}.png', 'wave': tri_waves[i],
                       'image': tri_pics[i]} for i in range(B)]
                  for B in (1, 5, 32)}
    tri_out, c_tri = counts_after(lambda: (
        tri.warmup((1, 8, 32)),
        {B: tri.predict_multimodal_batch(batch_reqs[B]) for B in (1, 5, 32)},
        tri.predict_multimodal(**requests[0]))[1:])
    dispatches = 3 + 3 * len(seqs) + 3 + 1
    want_only(c_tri, ('speech_dnn', 'max_pool_3x3s2', 'layer1'), dispatches,
              f'host-feature tri-modal engine ({dispatches} dispatches a '
              'leg)')
    k_packed = tri._run_trimodal(tri_waves[:8], (TEXTS * 2)[:8], tri_pics[:8])
    c_packed = tri_cpu._run_trimodal(tri_waves[:8], (TEXTS * 2)[:8],
                                     tri_pics[:8])
    check(k_packed.shape == (8, 34) and bool(np.isfinite(k_packed).all()),
          f'host-feature tri-modal rows {k_packed.shape}')
    e_tri = float(np.abs(k_packed - c_packed).max())
    e_speech = float(np.abs(k_packed[:, :7] - c_packed[:, :7]).max())
    check(e_tri <= TRI_BAND and e_speech <= SPEECH_BAND,
          f'host-feature tri-modal against cpu: {e_tri} (speech '
          f'{e_speech})')
    singles, batch5 = tri_out[1], tri_out[0][5]
    for g, r in ((singles, tri_cpu.predict_multimodal(**requests[0])),) + \
            tuple(zip(batch5, tri_cpu.predict_multimodal_batch(
                batch_reqs[5]))):
        for mod in ('speech', 'text', 'image', 'fusion'):
            check_results([g[mod]], [r[mod]], TRI_BAND,
                          f'host-feature tri-modal {mod}')
    print(f'host: bf16 tri-modal engine (host features, phase 6 trees, '
          f'card scales): {dispatches} dispatches a leg, launches {c_tri}; '
          f'34 packed values against device=cpu max|err| {e_tri:.3e} <= '
          f'{TRI_BAND} (speech {e_speech:.3e} <= {SPEECH_BAND})')

    # the facade on the card: the parity frontend, K2 once
    path = requests[0]['audio_path']
    feats, c_pre = counts_after(lambda: preprocess_audio(path))
    want_only(c_pre, ('tuning_select',), 1, 'preprocess_audio')
    feats_cpu = preprocess_audio(path, device='cpu')
    pre_ratio = float((np.abs(feats - feats_cpu)
                       / (1e-4 + 2e-6 * np.abs(feats_cpu))).max())
    check(feats.shape == (56,) and pre_ratio <= 1.0,
          f'preprocess_audio card against cpu: {pre_ratio:.3f}x the parity '
          'contract 1e-4 + 2e-6|c|')
    print(f'host: preprocess_audio on the card: launches {c_pre}; against '
          f'device=cpu max|err| {float(np.abs(feats - feats_cpu).max()):.3e}'
          f', worst {pre_ratio:.3f} of 1e-4 + 2e-6|c|')

    # host timings, each in turns (numpy or Python first)
    for B in (1, 32):
        t = in_turns({'numpy': lambda: wire.encode_pcm12_np(clips[:B]),
                      'native': lambda: wire.encode_pcm12(clips[:B])}, 10)
        u = in_turns({'numpy': lambda: wire.encode_yuv420_np(pics[:B]),
                      'native': lambda: wire.encode_yuv420(pics[:B])}, 10)
        print(f'time host encode_pcm12 B={B:2d}: numpy {t["numpy"]:.3f} ms, '
              f'native {t["native"]:.3f} ms; encode_yuv420 B={B:2d}: numpy '
              f'{u["numpy"]:.3f} ms, native {u["native"]:.3f} ms (medians '
              f'of 10, in turns); {host}; {card}')
    py_tok = WordPieceTokenizer(make_vocab())
    t = in_turns({'python': lambda: py_tok.encode_batch(texts, 128),
                  'native': lambda: tok.encode_batch(texts, 128)}, 10)
    print(f'time host WordPiece encode_batch 32 texts max_length 128: Python '
          f'{t["python"]:.3f} ms, native {t["native"]:.3f} ms (medians of '
          f'10, in turns); {host}; {card}')
    for B in (1, 8, 32):
        t = in_turns({'numpy': lambda: host_features.features_56_np(
                          clips[:B]),
                      'native': lambda: featurizer.extract56(clips[:B])},
                     2 if B == 32 else 3)
        wire_w = wave_speech._to_device(wave_speech._wire_waves(clips[:B], B))
        wire_f = speech._to_device(speech._wire_waves(clips[:B], B))
        step_w = cuda_ms(lambda: wave_speech._speech_forward(wire_w))
        step_f = cuda_ms(lambda: speech._speech_forward(wire_f))
        print(f'time host featurizer B={B:2d}: features_56_np '
              f'{t["numpy"]:.3f} ms, extract56 {t["native"]:.3f} ms (host, '
              f'in turns); bf16 speech device step: waveform wire '
              f'{step_w:.4f} ms, host-feature wire {step_f:.4f} ms (CUDA '
              f'events, wire on the card); {host}; {card}')
    reqs32 = batch_reqs[32]
    walls = {('b1', 'waveform'): [], ('b1', 'host'): [],
             ('b32', 'waveform'): [], ('b32', 'host'): []}
    for name, eng in (('waveform', wave_tri), ('host', tri),
                      ('host', tri), ('waveform', wave_tri)):
        for _ in range(10):
            t0 = time.perf_counter()
            eng.predict_multimodal(**requests[0])
            walls['b1', name].append((time.perf_counter() - t0) * 1e3)
        for _ in range(5):
            t0 = time.perf_counter()
            eng.predict_multimodal_batch(reqs32)
            walls['b32', name].append((time.perf_counter() - t0) * 1e3)
    print('time tri-modal host wall by audio wire (in turns waveform, host, '
          'host, waveform): '
          + '; '.join(f'{b} {name} p50 {statistics.median(v):.2f} ms (min '
                      f'{min(v):.2f}, max {max(v):.2f}, n {len(v)})'
                      for (b, name), v in walls.items())
          + f' (b1: predict_multimodal, WAV + PNG decode; b32: '
          f'predict_multimodal_batch on decoded arrays); {host}; {card}')
    counts = {n: c_speech[n] + c_tri[n] for n in wrappers}
    del speech, speech_cpu, tri, tri_cpu
    torch.cuda.empty_cache()
    print(f'host phase wall: {time.perf_counter() - t_phase:.1f} s; {card}')
    return counts, {'speech': 6, 'trimodal': dispatches}


# ----------------------------------------------------------------------
# phase 7b: the roofline and trace helpers (mec_tpu_torch/utils/)
# ----------------------------------------------------------------------
# the __global__ functions each kernel of the tri-modal b1 dispatch
# launches, as the trace must name them
TRACE_KERNELS = {'mfcc_mean': ('mfcc_mean_kernel',),
                 'tuning_select': ('tuning_select_kernel',),
                 'rolloff_bins': ('rolloff_bins_kernel',),
                 'speech_dnn': ('speech_dnn_kernel',),
                 'max_pool_3x3s2': ('max_pool_3x3s2_kernel',),
                 'layer1': ('conv1x1_in_kernel', 'conv3x3_kernel',
                            'conv256_kernel')}
# measure_hbm_gbps against the data sheet's 3.35 TB/s: below half, the
# probe measured something else; above 1.05, an impossible reading
RATE_BAND = (0.5, 1.05)
# a graph chain may beat phase 7's device_ms (its inputs stay in the
# 50 MB L2 across calls), but not by this much: below it the chain
# skipped work
CHAIN_FLOOR = 0.3
# the tri-modal step's modelled bytes over its time against the measured
# rate: above this the reading is impossible (JAX's guard, bench.py)
TRAFFIC_CAP = 1.05
# the phase clock's medians must sum to the median wall within
# max(1 ms, 15%) (tests/test_bench_contract.py:170-174)
PHASE_SUM_MS, PHASE_SUM_SHARE = 1.0, 0.15
B1_PHASES = ('wav_load', 'tokenize', 'image_load', 'wire_encode',
             'dispatch_fetch', 'result_unpack')


def roofline_phase(card, timed, times, eng, request, step_b32, wires_b32):
    """Phase 7b: (a) measure_hbm_gbps on the card; (b) chain_slope_ms of
    each kernel wrapper of phase 7 (`timed`: K1-K7, K5 in both
    precisions) captured into CUDA graphs, beside phase 7's device_ms
    (`times`); (c) hbm_traffic_bytes of the bf16 tri-modal b32 step
    (`eng`, on `wires_b32`) over phase 7's step time `step_b32`; (d)
    device_trace around tri-modal b1 requests, which must name the
    kernels' __global__ functions; (e) the engine's batch-1 phase clock
    over 20 predict_multimodal calls of `request`. Returns each kernel's
    chain_ms."""
    import torch
    from mec_tpu_torch.utils import roofline
    from mec_tpu_torch.utils.profiling import device_trace
    t_phase = time.perf_counter()

    # (a) the memory rate
    gbps = roofline.measure_hbm_gbps()
    rate_share = gbps * 1e9 / roofline.PEAKS['memory']
    print(f'roofline: measure_hbm_gbps {gbps:.1f} GB/s (10^9 B/s; x.sum() '
          f'over 256 MiB of fp32, slope of CUDA-graph chains of 40 and 160)'
          f' = {rate_share:.3f} of the data sheet\'s 3.35 TB/s; {card}')
    check(RATE_BAND[0] <= rate_share <= RATE_BAND[1],
          f'measured memory rate {gbps:.1f} GB/s is {rate_share:.3f} of the '
          f'data sheet, outside {RATE_BAND}')

    # (b) each wrapper captured into a graph chain
    chains = {}
    with torch.inference_mode():
        for name, (kern, _plain) in timed.items():
            try:
                ms = roofline.chain_slope_ms(lambda eps, kern=kern: kern())
            except RuntimeError as e:
                fail(f'{name}: chain_slope_ms failed (the wrapper cannot '
                     f'be captured into a CUDA graph?): {e}')
            chains[name] = ms
            dev_ms = times[name][3]
            ratio = None if dev_ms is None else ms / dev_ms
            print(f'chain {name:22s} B=32: {ms:.4f} ms a call (CUDA-graph '
                  f'chains of 40 and 160), device_ms {fmt_ms(dev_ms)}, chain '
                  f'/ device ' + ('not measured' if ratio is None
                                  else f'{ratio:.3f}')
                  + f', event ms {times[name][0]:.4f}; {card}')
            check(ms > 1e-6, f'{name}: the chain\'s slope is not positive')
            # a device_ms the profiler lost (phase 7) leaves no ratio
            if ratio is not None:
                check(ratio >= CHAIN_FLOOR,
                      f'{name}: chain {ms:.4f} ms is {ratio:.3f} of '
                      f'device_ms {dev_ms:.4f} (< {CHAIN_FLOOR}): the chain '
                      f'skipped work')

    # (c) the tri-modal b32 step's traffic against the measured rate
    tr = roofline.hbm_traffic_bytes(eng._trimodal_forward, *wires_b32)
    implied = tr['model_bytes'] / (step_b32 * 1e-3)
    traffic_share = implied / (gbps * 1e9)
    print(f'traffic trimodal bf16 B=32: model {tr["model_bytes"] / 1e6:.1f} '
          f'MB (args {tr["arg_bytes"] / 1e6:.1f}, out '
          f'{tr["out_bytes"] / 1e3:.1f} kB, temp {tr["temp_bytes"] / 1e6:.1f}'
          f'), logical {tr["logical_bytes"] / 1e6:.1f} MB, '
          f'{tr["flops"] / 1e9:.2f} GFLOP counted (the ctypes kernels '
          f'unseen); over the {step_b32:.4f} ms step '
          f'{implied / 1e9:.1f} GB/s = {traffic_share:.3f} of the measured '
          f'rate; {card}')
    check(traffic_share <= TRAFFIC_CAP,
          f'tri-modal b32: {traffic_share:.3f} of the measured rate > '
          f'{TRAFFIC_CAP}: an impossible reading')

    # (d) a trace of tri-modal b1 requests (the first warms the window)
    with tempfile.TemporaryDirectory(prefix='chip_smoke_trace_') as d:
        with device_trace(d):
            for _ in range(6):
                eng.predict_multimodal(**request)
            torch.cuda.synchronize()
        files = [os.path.join(d, f) for f in os.listdir(d)]
        check(len(files) == 1 and files[0].endswith('.pt.trace.json'),
              f'device_trace wrote {os.listdir(d)}')
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f).get('traceEvents', [])
    kernels = [e.get('name', '') for e in events
               if str(e.get('cat', '')).lower() == 'kernel']
    missing = [fn for fns in TRACE_KERNELS.values() for fn in fns
               if not any(fn in k for k in kernels)]
    print(f'trace: device_trace around 6 tri-modal b1 requests wrote '
          f'{size / 1e6:.1f} MB, {len(events)} events, {len(kernels)} '
          f'kernel events; ' + ', '.join(
              f'{fn} {sum(fn in k for k in kernels)}'
              for fns in TRACE_KERNELS.values() for fn in fns) + f'; {card}')
    check(not missing, f'the trace names no kernel event of {missing}')

    # (e) the batch-1 phase clock
    walls, phases = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        eng.predict_multimodal(**request)
        walls.append((time.perf_counter() - t0) * 1e3)
        phases.append(dict(eng._last_b1_phases))
    check(all(tuple(p) == B1_PHASES for p in phases),
          f'_last_b1_phases keys {sorted(phases[-1])}')
    med = {k: statistics.median(p[k] for p in phases) for k in B1_PHASES}
    total, wall = sum(med.values()), statistics.median(walls)
    print('phases predict_multimodal b1 (medians of 20, ms): '
          + ', '.join(f'{k} {v:.3f}' for k, v in med.items())
          + f'; sum {total:.3f} against the median wall {wall:.3f} (min '
          f'{min(walls):.3f}); {card}')
    check(abs(total - wall) <= max(PHASE_SUM_MS, PHASE_SUM_SHARE * wall),
          f'b1 phases sum to {total:.3f} ms against a {wall:.3f} ms wall')
    print(f'roofline phase wall: {time.perf_counter() - t_phase:.1f} s; '
          f'{card}')
    return chains


def main():
    t_start = time.perf_counter()
    # the phases before 6g drive the waveform wire (K1-K3 once a bf16
    # dispatch): on a host with >= 4 CPUs and g++, 'auto' would featurize
    # audio on the host instead. Set before mec_tpu_torch.config is
    # imported; the CLI and .env subprocesses inherit it. Phase 6g turns
    # the feature on itself.
    os.environ['MEC_HOST_AUDIO_FEATURES'] = '0'
    if not os.path.isdir(os.path.join(HERE, 'mec_tpu_torch')):
        fail('mec_tpu_torch/ is not beside chip_smoke.py: run it from a '
             'checkout of the repository')
    sys.path.insert(0, HERE)
    import torch

    # the trainers' model_metrics rows (training/common.record_metrics) go
    # to a database of this run, not to the checkout's default file
    run_tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_db_')
    os.environ.setdefault('DATABASE_URL', 'sqlite:///' + os.path.join(
        run_tmp.name, 'metrics.db'))

    # ---------------------------------------------------------- 1 device
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this needs an NVIDIA GPU')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f'nvidia-smi failed: {smi.stderr}')
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    print(f'device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}'
          f' | CUDA {torch.version.cuda}')

    # ----------------------------------------------------------- 2 build
    import mec_tpu_torch  # noqa: F401  (TF32 off)
    from mec_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    print(f'build: {time.perf_counter() - t0:.2f} s (nvcc '
          f'{_build.build_info["seconds"]:.2f} s)')
    for line in _build.build_info['log'].splitlines():
        if 'registers' in line or 'Compiling entry' in line:
            print('  ptxas:', line.strip().split('ptxas info    : ')[-1])

    import torch.nn.functional as F
    from mec_tpu_torch.ops import audio_features as af
    from mec_tpu_torch.ops import (dft_kernel, pool_kernel, resnet_kernel,
                                   rolloff_kernel, speech_kernels,
                                   tuning_kernel)
    from mec_tpu_torch.ops.quant import extract_static_scales
    from mec_tpu_torch.serving.engine import EmotionEngine
    from mec_tpu_torch.serving.synthetic_artifacts import (image_variables,
                                                           speech_variables)
    speech_names = ('mfcc_mean', 'tuning_select', 'rolloff_bins',
                    'speech_dnn')
    image_names = ('max_pool_3x3s2', 'layer1')
    wrappers = {'mfcc_mean': speech_kernels.mfcc_mean,
                'tuning_select': tuning_kernel.tuning_select,
                'rolloff_bins': rolloff_kernel.rolloff_bins,
                'speech_dnn': speech_kernels.speech_dnn,
                'dft_spectrograms': dft_kernel.dft_spectrograms,
                'max_pool_3x3s2': pool_kernel.max_pool_3x3s2,
                'layer1': resnet_kernel.layer1}
    hann = af._consts(dev)['hann']

    def noise_frames(B):
        """K5's input on the framed path: Hann-windowed center frames
        (B, 130, 2048) of 0.1-scale noise (the JAX contract's clips)."""
        y = np.random.RandomState(B).randn(B, N).astype(np.float32) * 0.1
        return af.frame_signal(torch.from_numpy(y).to(dev), edge=False) * hann

    # --------------------------------------------------------- 3 kernels
    tree = speech_variables(seed=2)
    errs = {}

    def check_tuning(what, mags, residual, pitches):
        kb, kh = tuning_kernel.tuning_select(mags, residual, pitches)
        kb2, kh2 = tuning_kernel.tuning_select(mags, residual, pitches)
        pb, ph = tuning_kernel.tuning_select_plain(mags, residual, pitches)
        torch.cuda.synchronize()
        check(torch.equal(kb, pb) and torch.equal(kh, ph),
              f'tuning_select {what}: not bit-exact ({kb.tolist()} vs '
              f'{pb.tolist()}, {kh.tolist()} vs {ph.tolist()})')
        check(torch.equal(kb, kb2) and torch.equal(kh, kh2),
              f'tuning_select {what}: two runs on the same input differ')
        errs['tuning_select'] = 0.0
        n = mags.shape[0]
        print(f'kernel tuning_select {what}: best bins and has_any equal '
              f'(bit-exact), two runs identical; {int(kh.sum())}/{n} clips '
              f'select, {(pitches > 0).float().mean().item():.3f} of the '
              f'slots are candidates; a cluster of '
              f'{tuning_kernel.cluster_split(n)} blocks a clip')

    inputs32 = None
    for B in (32, 1, 8, 33):
        y = torch.from_numpy(waves(32, seed=0)[-B:] if B == 1
                             else waves(B, seed=0)).to(dev)
        mag, P = af.hop_spectrograms(y)
        mags, pitches = af.tuning_candidates(P)
        residual = af.fold_residual(pitches)
        rows = mag.reshape(-1, mag.shape[-1])
        feats = af.audio_features_56(y)
        if B == 32:
            mean = feats.mean(dim=0)
            scale = feats.std(dim=0) + 1e-3
            fwd = speech_kernels.make_speech_dnn(tree, dev)
        x = ((feats - mean) / scale).contiguous()
        if B == 32:
            inputs32 = (P, mags, residual, pitches, rows, x)

        # K1: differs from the plain version only in summation order (and
        # log10f's last bit); MFCC0 of the silent clip is -1131, where
        # one f32 ulp is 1.2e-4: |k - p| <= 1e-4 + 2e-6 |p|
        k, p = speech_kernels.mfcc_mean(P), speech_kernels.mfcc_mean_plain(P)
        k_again = speech_kernels.mfcc_mean(P)
        torch.cuda.synchronize()
        err = (k - p).abs().max().item()
        ratio = ((k - p).abs() / (1e-4 + 2e-6 * p.abs())).max().item()
        check(ratio <= 1.0,
              f'mfcc_mean B={B}: |err| up to {ratio:.2f}x 1e-4 + 2e-6|p|')
        check(torch.equal(k, k_again),
              f'mfcc_mean B={B}: two runs on the same input differ')
        errs['mfcc_mean'] = max(errs.get('mfcc_mean', 0.0), err)
        print(f'kernel mfcc_mean     B={B:2d}: max|err| {err:.3e}, worst '
              f'|err| / (1e-4 + 2e-6|p|) = {ratio:.3f} (<= 1), two runs '
              f'bit-identical; a cluster of {speech_kernels.frame_split(B)} '
              f'blocks a clip')

        # K4: fp32 FMAs in another order than cuBLAS; the JAX kernel
        # test's bounds: probs 2e-6, penult 2e-5, zeros past column 71
        k = fwd(x)
        p = speech_kernels.speech_dnn_plain(x, fwd.params, fwd.dims)
        torch.cuda.synchronize()
        e_prob = (k[:, :7] - p[:, :7]).abs().max().item()
        e_pen = (k[:, 7:] - p[:, 7:]).abs().max().item()
        check(e_prob <= 2e-6 and e_pen <= 2e-5,
              f'speech_dnn B={B}: probs err {e_prob}, penult err {e_pen}')
        check(bool((k[:, 71:] == 0).all()), 'speech_dnn: columns 71+ not 0')
        errs['speech_dnn'] = max(errs.get('speech_dnn', 0.0), e_prob, e_pen)
        print(f'kernel speech_dnn    B={B:2d}: probs max|err| {e_prob:.3e} '
              f'(<= 2e-6), penult {e_pen:.3e} (<= 2e-5)')

        # K2: integer and compare work only -> bit-exact, and the same
        # on every run although block 0 gathers the pairs in any order
        check_tuning(f'B={B:2d}', mags, residual, pitches)

        # K3: bins equal, except a one-bin step where the crossing is a
        # near-tie: the f64 prefix at the lower bin within F * 2**-24 of
        # the f64 threshold, relative to the row total (the worst-case
        # rounding of an f32 sum of F = 1025 terms)
        kbin = rolloff_kernel.rolloff_bins(rows)
        pbin = rolloff_kernel.rolloff_bins_plain(rows)
        torch.cuda.synchronize()
        diff = (kbin - pbin).abs()
        bad = torch.nonzero(diff).flatten().tolist()
        for r in bad:
            cum = torch.cumsum(rows[r].double(), 0)
            lo_bin = min(kbin[r].item(), pbin[r].item())
            tie = abs(cum[lo_bin].item() - 0.85 * cum[-1].item())
            check(diff[r].item() == 1
                  and tie <= rows.shape[1] * 2.0 ** -24 * cum[-1].item(),
                  f'rolloff_bins B={B} row {r}: kernel {kbin[r].item()} vs '
                  f'plain {pbin[r].item()} is not a near-tie')
        errs['rolloff_bins'] = max(errs.get('rolloff_bins', 0.0),
                                   float(diff.max().item()))
        print(f'kernel rolloff_bins  B={B:2d}: {len(bad)} of {rows.shape[0]} '
              f'rows differ, each a one-bin near-tie; '
              f'{rolloff_kernel.rows_per_block(rows.shape[0])} rows a block')

        if B not in (32, 1):
            continue    # K1-K4 alone are held at the two extra sizes

        # K5, both precisions, against the plain version on the same frames
        frames = noise_frames(B)
        if B == 32:
            frames32 = frames
        for prec in dft_kernel.PRECISIONS:
            km, kp = dft_kernel.dft_spectrograms(frames, prec)
            pm, pp = dft_kernel.dft_spectrograms_plain(frames, prec)
            torch.cuda.synchronize()
            check(km.shape == (B, 130, 1025) and kp.shape == km.shape,
                  f'dft_spectrograms B={B}: shape {tuple(km.shape)}')
            e_mag = (km - pm).abs().max().item()
            rel = ((kp - pp).abs() / (pp + 1e-6)).max().item()
            check(e_mag <= K5_MAG_ATOL and rel <= K5_P_REL,
                  f'dft_spectrograms {prec} B={B}: mag err {e_mag}, P rel '
                  f'{rel}')
            errs['dft_spectrograms'] = max(errs.get('dft_spectrograms', 0.0),
                                           e_mag)
            print(f'kernel dft_spectrograms {prec:7s} B={B:2d}: mag max|err| '
                  f'{e_mag:.3e} (<= {K5_MAG_ATOL}), P max rel {rel:.3e} '
                  f'(<= {K5_P_REL})')

    # K2 where its work is largest and where there is none
    rng = np.random.RandomState(4)
    for what, y in (('noise-only B=8', 0.01 * np.arange(1, 9)[:, None]
                     * rng.randn(8, N)), ('silent clip', np.zeros((1, N)))):
        P = af.hop_spectrograms(torch.from_numpy(y.astype(np.float32)).to(dev))[1]
        mags, pitches = af.tuning_candidates(P)
        check_tuning(what, mags, af.fold_residual(pitches), pitches)
    P, mags, residual, pitches, rows, x = inputs32

    # K6, K7 on the image path's own tensors: the bf16 int8-static
    # engine's model (calibrated on the card) turns seeded 224 px images
    # into the post-ReLU stem map (K6's input) and the pooled map (K7's)
    t0 = time.perf_counter()
    img_tree, img_meta = image_variables(seed=IMAGE_SEED)
    img_engine = EmotionEngine(image_variables=img_tree, image_meta=img_meta,
                               compute_dtype='bfloat16', device='cuda')
    check(img_engine._image_quant_mode == 'static',
          f'image engine serves {img_engine._image_quant_mode} int8')
    print(f'image engine: bf16, BN folded, int8 static, calibrated on the '
          f'card in {time.perf_counter() - t0:.2f} s')
    model = img_engine.image['model']
    blocks = [getattr(model, n) for n in model.stages[0]]
    img_mean, img_std = img_engine.image['mean'], img_engine.image['std']
    image_inputs32 = None
    with torch.inference_mode():
        for B in (32, 1):
            u8 = torch.from_numpy(images(32, seed=3)[-B:]).to(dev)
            xn = (u8.float() / 255.0 - img_mean) / img_std
            stem = F.relu(model.conv1(xn.to(torch.bfloat16))).contiguous()
            pooled = pool_kernel.max_pool_3x3s2_plain(stem)
            if B == 32:
                image_inputs32 = (stem, pooled)
            # K6: a max moves values -> bit-exact
            k = pool_kernel.max_pool_3x3s2(stem)
            torch.cuda.synchronize()
            check(torch.equal(k, pooled),
                  f'max_pool_3x3s2 B={B}: not bit-exact')
            errs['max_pool_3x3s2'] = 0.0
            print(f'kernel max_pool_3x3s2 B={B:2d}: {tuple(stem.shape)} -> '
                  f'{tuple(k.shape)} bit-exact')
            # K7: exact integer sums, same rounding points -> bit-exact
            k = resnet_kernel.layer1(pooled, blocks)
            p = resnet_kernel.layer1_plain(pooled, blocks)
            torch.cuda.synchronize()
            err = (k.float() - p.float()).abs().max().item()
            check(torch.equal(k, p), f'layer1 B={B}: not bit-exact '
                  f'(max |err| {err})')
            errs['layer1'] = max(errs.get('layer1', 0.0), err)
            print(f'kernel layer1        B={B:2d}: {tuple(pooled.shape)} -> '
                  f'{tuple(k.shape)} bit-exact')

    # ---------------------------------------------------------- 4 engine
    from mec_tpu_torch.config import Config
    from mec_tpu_torch.convert.from_jax import speech_state_from_jax
    from mec_tpu_torch.models.speech_dnn import SpeechDNN
    from mec_tpu_torch.ops import wav
    from mec_tpu_torch.serving.batcher import EngineBatcher

    scaler = (mean.cpu().numpy(), scale.cpu().numpy())

    def speech_engine(device, dtype):
        """The speech engine alone; a bf16 one at MEC_DFT_PRECISION=high
        (the hop-slab frontend), an fp32 one takes the parity graph."""
        old = Config.DFT_PRECISION
        Config.DFT_PRECISION = 'high'
        try:
            return EmotionEngine(tree, scaler, compute_dtype=dtype,
                                 device=device)
        finally:
            Config.DFT_PRECISION = old

    def speech_agreement(pairs, band, what):
        """Largest |probs| and |penult| difference over (got, ref) result
        lists; decisions equal wherever the reference's top-2 margin
        exceeds the band."""
        worst = 0.0
        for got, ref in pairs:
            check(len(got) == len(ref), f'{what}: result count mismatch')
            for g, r in zip(got, ref):
                check(g is not None and '_fallback' not in g,
                      f'{what}: fallback: {g}')
                check(abs(sum(g['all_probabilities']) - 1.0) <= 1e-5,
                      f'{what}: probabilities sum to '
                      f'{sum(g["all_probabilities"])}')
                e = float(np.max(np.abs(np.subtract(g['all_probabilities'],
                                                    r['all_probabilities']))))
                if '_features' in g:
                    e = max(e, float(np.abs(g['_features']
                                            - r['_features']).max()))
                check(e <= band, f'{what}: differs from cpu by {e} > {band}')
                top2 = np.sort(r['all_probabilities'])[-2:]
                check(top2[1] - top2[0] <= band or g['emotion'] == r['emotion'],
                      f'{what}: decision {g["emotion"]} vs cpu {r["emotion"]}')
                worst = max(worst, e)
        return worst

    engine = speech_engine('cuda', 'bfloat16')
    cpu_engine = speech_engine('cpu', 'bfloat16')
    check(engine._dft_precision == 'high' and engine._compress
          and len(engine._wire_waves(waves(2, seed=1), 2)) == 2,
          'the bf16 speech engine is not the hop-slab, pcm12-wire engine')
    clips = waves(32, seed=1)
    tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_')
    paths = []
    for i in range(4):
        paths.append(os.path.join(tmp.name, f'clip{i}.wav'))
        wav.write_wav(paths[-1], clips[i + 1], 22050)

    for w in wrappers.values():
        w.launches = 0
    engine.warmup((1, 8, 32))
    results = {B: engine.predict_speech_waves(clips[:B], want_features=True)
               for B in (1, 5, 32)}
    batcher = EngineBatcher(engine)
    try:
        served = serve_through(batcher.speech, paths)
    finally:
        batcher.stop()
    counts = {name: w.launches for name, w in wrappers.items()}
    dispatches = 3 + 3 + batcher.stats()['speech']['batches']
    print(f'engine (bf16 serving): {dispatches} speech dispatches (3 warmup, '
          f'3 direct, {dispatches - 6} batcher); launches {counts}')
    for name, n in counts.items():
        want = dispatches if name in speech_names else 0
        check(n == want, f'{name} launched {n} times in {dispatches} '
              f'speech dispatches (want {want})')
    pairs = [(results[B], cpu_engine.predict_speech_waves(
        clips[:B], want_features=True)) for B in (1, 5, 32)]
    pairs.append((served, cpu_engine.predict_speech_paths(paths)))
    worst = speech_agreement(pairs, SPEECH_BAND, 'bf16 speech engine')
    labels = sorted({r['emotion'] for r in results[32]})
    print(f'engine (bf16 serving): results agree with device=cpu (probs and '
          f'penult max|err| {worst:.2e} <= {SPEECH_BAND}); no fallbacks; '
          f'decisions at B=32: {labels}')

    # the fp32 parity engine: the reference's fp32 graph. On the card it
    # launches the tuning selection (K2) alone; the MFCC, the rolloff and
    # the DNN are plain tensor work there, as in the reference
    parity = speech_engine('cuda', 'float32')
    parity_cpu = speech_engine('cpu', 'float32')
    check(parity._dft_precision == 'parity'
          and parity._wire_waves(clips, 32)[0].dtype == np.float32,
          'the fp32 speech engine is not the float32-wire parity engine')
    for w in wrappers.values():
        w.launches = 0
    results32 = {B: parity.predict_speech_waves(clips[:B], want_features=True)
                 for B in (1, 5, 32)}
    counts = {name: w.launches for name, w in wrappers.items()}
    for name, n in counts.items():
        want = 3 if name == 'tuning_select' else 0
        check(n == want, f'{name} launched {n} times in 3 dispatches of the '
              f'fp32 parity engine (want {want})')
    worst32 = speech_agreement(
        [(results32[B], parity_cpu.predict_speech_waves(
            clips[:B], want_features=True)) for B in (1, 5, 32)],
        1e-4, 'fp32 parity speech engine')
    # the plain live-BN model on the parity features: the same answer
    model = SpeechDNN().to(dev).eval()
    model.load_state_dict(speech_state_from_jax(tree))
    with torch.no_grad():
        feats = af.audio_features_56(torch.from_numpy(clips).to(dev), 'parity')
        m_probs, m_pen = model((feats - mean) / scale)
    got_probs = np.array([r['all_probabilities'] for r in results32[32]])
    got_pen = np.stack([r['_features'] for r in results32[32]])
    e_model = max(np.abs(got_probs - m_probs.cpu().numpy()).max(),
                  np.abs(got_pen - m_pen.cpu().numpy()).max())
    check(e_model <= 1e-4, f'parity engine vs plain SpeechDNN: {e_model}')
    print(f'engine (fp32 parity): 3 dispatches, launches {counts}; results '
          f'agree with device=cpu (probs and penult max|err| {worst32:.2e} '
          f'<= 1e-4) and with the plain SpeechDNN on the parity features '
          f'({e_model:.2e})')
    tmp.cleanup()

    # ----------------------------------------------------------- 5 image
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    print('PIL: present' if have_pil else
          'PIL: absent; the 4 PNG requests are skipped (their decode runs '
          'on the host and touches no kernel)')
    cpu_meta = dict(img_meta, int8_scales={
        img_engine._image_scales_key():
            extract_static_scales(img_engine.image['variables'])})
    img_cpu = EmotionEngine(image_variables=img_tree, image_meta=cpu_meta,
                            compute_dtype='bfloat16', device='cpu')
    check(img_cpu._image_scales_cached, 'cpu engine did not take the '
          'card engine\'s scales')
    pics = images(32, seed=5)
    tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_')
    png_paths = []
    if have_pil:
        from PIL import Image
        for i in range(4):
            png_paths.append(os.path.join(tmp.name, f'img{i}.png'))
            Image.fromarray(pics[i + 3]).save(png_paths[-1])

    for w in wrappers.values():
        w.launches = 0
    img_engine.warmup((1, 8, 32))
    img_results = {B: img_engine.predict_images(pics[:B], want_features=True)
                   for B in (1, 5, 32)}
    img_served = []
    img_batches = 0
    if have_pil:
        batcher = EngineBatcher(img_engine)
        try:
            img_served = serve_through(batcher.image, png_paths)
        finally:
            batcher.stop()
        img_batches = batcher.stats()['image']['batches']
    counts = {name: w.launches for name, w in wrappers.items()}
    img_dispatches = 3 + 3 + img_batches
    print(f'image engine: {img_dispatches} image dispatches (3 warmup, 3 '
          f'direct, {img_batches} batcher); launches {counts}')
    for name, n in counts.items():
        want = img_dispatches if name in image_names else 0
        check(n == want, f'{name} launched {n} times in {img_dispatches} '
              f'image dispatches (want {want})')

    for B in (1, 5, 32):
        for r in img_results[B]:
            check(r['_features'].shape == (512,)
                  and bool(np.isfinite(r['_features']).all()),
                  'image features not finite (512,)')
    worst = max(check_results(img_results[B], img_cpu.predict_images(
        pics[:B]), IMAGE_BAND, f'image bf16 B={B}') for B in (1, 5))
    if have_pil:
        worst = max(worst, check_results(
            img_served, img_cpu.predict_image_paths(png_paths), IMAGE_BAND,
            'image PNGs via batcher'))
    labels = sorted({r['emotion'] for r in img_results[32]})
    check(len(labels) > 1, f'image decisions at B=32 all {labels}')
    print(f'image engine: bf16 int8-static results agree with device=cpu '
          f'(max probs err {worst:.3e} <= {IMAGE_BAND}); no fallbacks; '
          f'decisions at B=32: {labels}')

    # fp32 parity mode (live BN, fp32 convs with TF32 off, plain pool)
    img32 = EmotionEngine(image_variables=img_tree, image_meta=img_meta,
                          compute_dtype='float32', device='cuda')
    img32_cpu = EmotionEngine(image_variables=img_tree, image_meta=img_meta,
                              compute_dtype='float32', device='cpu')
    before = {n: wrappers[n].launches for n in image_names}
    got32 = img32.predict_images(pics[:5], want_features=True)
    check({n: wrappers[n].launches for n in image_names} == before,
          'fp32 parity mode launched an image kernel')
    ref32 = img32_cpu.predict_images(pics[:5], want_features=True)
    worst32 = check_results(got32, ref32, 1e-4, 'image fp32 B=5')
    e_feat = max(float(np.abs(g['_features'] - r['_features']).max())
                 for g, r in zip(got32, ref32))
    check(e_feat <= 1e-4, f'image fp32 features differ by {e_feat}')
    print(f'image engine: fp32 parity on the card agrees with device=cpu '
          f'(probs {worst32:.3e}, feat {e_feat:.3e} <= 1e-4)')
    tmp.cleanup()

    # -------------------------------------------------------- 6 trimodal
    from mec_tpu_torch.serving.synthetic_artifacts import (bert_variables,
                                                           fusion_variables,
                                                           make_vocab)
    check(have_pil, 'the tri-modal requests need PIL to decode their PNGs')
    t0 = time.perf_counter()
    bert_tree = bert_variables(seed=BERT_SEED)
    bert_kwargs = dict(vocab_size=30522, hidden_size=768, num_layers=12,
                       num_heads=12, intermediate_size=3072,
                       max_position=512, type_vocab_size=2, num_classes=7)
    fusion_tree = fusion_variables(seed=FUSION_SEED)
    vocab = make_vocab()
    print(f'trimodal: full-width trees from numpy seeds in '
          f'{time.perf_counter() - t0:.2f} s')

    def tri_engine(device, dtype, prec, bert_meta=None):
        """The tri-modal engine at MEC_DFT_PRECISION=prec; a bf16 engine
        takes the image engine's card-calibrated scales, and BERT's from
        bert_meta when given (else it calibrates on `device`)."""
        old = Config.DFT_PRECISION
        Config.DFT_PRECISION = prec
        try:
            return EmotionEngine(
                tree, scaler, image_variables=img_tree,
                image_meta=cpu_meta if dtype == 'bfloat16' else img_meta,
                bert_variables=bert_tree, bert_kwargs=bert_kwargs,
                bert_vocab=vocab, bert_meta=bert_meta,
                fusion_variables=fusion_tree, compute_dtype=dtype,
                device=device)
        finally:
            Config.DFT_PRECISION = old

    tri_waves = waves(32, seed=7)
    tri_pics = images(32, seed=8)
    tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_')
    requests = []
    for i in range(8):
        wp = os.path.join(tmp.name, f'tri{i}.wav')
        pp = os.path.join(tmp.name, f'tri{i}.png')
        wav.write_wav(wp, tri_waves[i + 1], 22050)
        Image.fromarray(tri_pics[i + 1]).save(pp)
        requests.append({'audio_path': wp, 'text': TEXTS[i],
                         'image_path': pp})
    seqs = sorted({s for s in Config.SEQ_BUCKETS
                   if s < Config.MAX_TEXT_LENGTH} | {Config.MAX_TEXT_LENGTH})
    tri = {}
    bert_meta = None
    tri_launches = {name: 0 for name in wrappers}
    per_dispatch = {}
    for prec in ('high', 'highest'):
        t0 = time.perf_counter()
        eng = tri_engine('cuda', 'bfloat16', prec, bert_meta)
        check(eng._all_live and eng._dft_precision == prec
              and eng._bert_quant_mode == 'static'
              and eng._image_quant_mode == 'static'
              and eng._compress, f'tri-modal engine ({prec}) is not the '
              'bf16 int8-static compressed-wire engine')
        scales = {eng._bert_scales_key():
                  extract_static_scales(eng.bert['variables'])}
        if bert_meta is None:
            bert_meta = {'int8_scales': scales}
            how = 'BERT calibrated on the card'
        else:
            check(eng._bert_scales_cached, 'BERT scales not taken')
            how = 'BERT scales of the first engine'
        print(f'trimodal engine ({prec}): built in '
              f'{time.perf_counter() - t0:.2f} s ({how})')
        for w in wrappers.values():
            w.launches = 0
        eng.warmup((1, 8, 32))
        singles = [eng.predict_multimodal(**r) for r in requests[:4]]
        batcher = EngineBatcher(eng)
        try:
            served = serve_through(batcher.multimodal, requests[4:])
        finally:
            batcher.stop()
        counts = {name: w.launches for name, w in wrappers.items()}
        n_batches = batcher.stats()['multimodal']['batches']
        dispatches = 3 + 3 * len(seqs) + 4 + n_batches
        print(f'trimodal engine ({prec}): {dispatches} dispatches per '
              f'modality leg (3 single-modality warmup, {3 * len(seqs)} '
              f'tri-modal warmup, 4 single requests, {n_batches} batcher); '
              f'launches {counts}')
        for name, n in counts.items():
            want = dispatches
            if name == 'dft_spectrograms' and prec == 'high':
                want = 0
            check(n == want, f'{name} launched {n} times in {dispatches} '
                  f'dispatches of the {prec} tri-modal engine (want {want})')
            tri_launches[name] += n
            if prec == 'highest':
                per_dispatch[name] = n / dispatches
        cpu_eng = tri_engine('cpu', 'bfloat16', prec, bert_meta)
        check(cpu_eng._bert_scales_cached and cpu_eng._image_scales_cached,
              'cpu tri-modal engine did not take the card\'s scales')
        for got, ref in ((singles, [cpu_eng.predict_multimodal(**r)
                                    for r in requests[:4]]),
                         (served, cpu_eng.predict_multimodal_batch(
                             requests[4:]))):
            for g, r in zip(got, ref):
                check(set(g) == {'speech', 'text', 'image', 'fusion'}
                      and 'attention_weights' in g['fusion'],
                      f'tri-modal result {sorted(g)}')
                for mod in g:
                    check_results([g[mod]], [r[mod]], TRI_BAND,
                                  f'tri-modal {prec} {mod}')
        texts8 = TEXTS[:4] * 2
        k_packed = eng._run_trimodal(tri_waves[:8], texts8, tri_pics[:8])
        c_packed = cpu_eng._run_trimodal(tri_waves[:8], texts8, tri_pics[:8])
        check(k_packed.shape == (8, 34) and bool(np.isfinite(k_packed).all()),
              f'packed tri-modal rows {k_packed.shape}')
        e_tri = float(np.abs(k_packed - c_packed).max())
        check(e_tri <= TRI_BAND, f'tri-modal {prec}: packed values differ '
              f'from cpu by {e_tri} > {TRI_BAND}')
        e_parts = {part: float(np.abs(k_packed[:, a:b] - c_packed[:, a:b])
                               .max())
                   for part, a, b in (('speech', 0, 7), ('text', 7, 14),
                                      ('image', 14, 21), ('fusion', 21, 28),
                                      ('attn', 28, 31), ('decision', 31, 34))}
        ties = 0
        for row_k, row_c in zip(k_packed, c_packed):
            for lo in (0, 7, 14, 21):
                top2 = np.sort(row_c[lo:lo + 7])[-2:]
                if top2[1] - top2[0] > TRI_BAND:
                    check(np.argmax(row_k[lo:lo + 7])
                          == np.argmax(row_c[lo:lo + 7]),
                          f'tri-modal {prec}: decision differs from cpu')
                else:
                    ties += 1
        labels = {mod: sorted({r[mod]['emotion'] for r in singles + served})
                  for mod in ('speech', 'text', 'image', 'fusion')}
        print(f'trimodal engine ({prec}): agrees with device=cpu (all 34 '
              f'packed values max|err| {e_tri:.3e} <= {TRI_BAND}; by part '
              + ', '.join(f'{k} {v:.3e}' for k, v in e_parts.items())
              + f'; decisions equal, {ties} of 32 near-ties within the '
              f'band); no fallbacks; decisions over 8 requests: {labels}')
        if prec == 'high':
            check(len(labels['text']) > 1, f'text decisions all '
                  f'{labels["text"]}: the synthetic BERT does not spread')
        tri[prec] = eng
        del cpu_eng

    # fp32 parity mode: fp32 BERT (erf GELU), fp32 ResNet50 (live BN),
    # float32 wire, the parity speech leg (rFFT frontend, live-BN DNN)
    t32 = tri_engine('cuda', 'float32', 'high')
    t32_cpu = tri_engine('cpu', 'float32', 'high')
    k_packed = t32._run_trimodal(tri_waves[:4], TEXTS[:4], tri_pics[:4])
    c_packed = t32_cpu._run_trimodal(tri_waves[:4], TEXTS[:4], tri_pics[:4])
    e_tri32 = float(np.abs(k_packed - c_packed).max())
    check(e_tri32 <= 1e-4, f'tri-modal fp32: packed values differ from cpu '
          f'by {e_tri32} > 1e-4')
    for row_k, row_c in zip(k_packed, c_packed):
        for lo in (0, 7, 14, 21):
            top2 = np.sort(row_c[lo:lo + 7])[-2:]
            check(top2[1] - top2[0] <= 1e-4
                  or np.argmax(row_k[lo:lo + 7]) == np.argmax(row_c[lo:lo + 7]),
                  'tri-modal fp32: decision differs from cpu')
    print(f'trimodal engine (fp32 parity): the card agrees with device=cpu '
          f'(all 34 packed values max|err| {e_tri32:.3e} <= 1e-4, '
          f'decisions equal)')
    del t32, t32_cpu

    def tri_wires(eng, B, texts):
        ids, mask = eng._to_device(eng._text_wire(texts, B))
        return (eng._to_device(eng._wire_waves(tri_waves[:B], B)), ids, mask,
                eng._to_device(eng._wire_image(tri_pics[:B], B)))

    # ----------------------------------------------------------- 6a train
    train_phase(card, wrappers, speech_names, requests)

    # ---------------------------------------------------------- 6b models
    from mec_tpu_torch.convert import store
    from mec_tpu_torch.inference import (ImageInference, MultimodalFusion,
                                         TextInference)
    from mec_tpu_torch.models.forest import forest_apply, forest_leaves
    from mec_tpu_torch.serving.engine import get_engine
    from mec_tpu_torch.serving.synthetic_artifacts import \
        write_synthetic_artifacts
    models_tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_models_')
    mdir = models_tmp.name
    t0 = time.perf_counter()
    write_synthetic_artifacts(mdir, seed=MODELS_SEED,
                              image_arch='mobilenet_v2', image_size=224)
    sizes = {f: os.path.getsize(os.path.join(r, f)) / 2 ** 20
             for r, _d, fs in os.walk(mdir) for f in fs if f.endswith('.mecp')}
    print(f'models: full-width directory written in '
          f'{time.perf_counter() - t0:.2f} s by the port\'s writer ('
          + ', '.join(f'{f} {mb:.1f} MiB' for f, mb in sorted(sizes.items()))
          + ')')
    saved = Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION
    Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = \
        'rf', 'bfloat16', 'high'
    try:
        t0 = time.perf_counter()
        m_eng = get_engine(mdir, reload=True)        # the default device
        load_first = time.perf_counter() - t0
        check(m_eng.device.type == 'cuda' and m_eng._fusion_kind == 'rf'
              and m_eng._image_arch == 'mobilenet_v2' and m_eng._all_live
              and m_eng._image_quant_mode == m_eng._bert_quant_mode
              == 'static' and not m_eng._image_scales_cached
              and m_eng.forest['arrays']['threshold'].is_cuda,
              'get_engine(models_dir) did not build the bf16 rf MobileNetV2 '
              'engine on the card')
        cached = {k for f in ('image_model.mecp', 'bert_model/bert_model.mecp')
                  for k in store.load_params(os.path.join(mdir, f))['meta']
                  .get('int8_scales', {})}
        check(cached == {m_eng._image_scales_key(), m_eng._bert_scales_key()},
              f'scales not written back to the .mecp metas: {cached}')
        n_trees = m_eng.forest['arrays']['feature'].shape[0]
        print(f'models engine: get_engine on cuda (bf16, rf fusion, '
              f'MobileNetV2 int8 static, {n_trees} trees of depth '
              f'{m_eng.forest["depth"]}) in {load_first:.2f} s, calibrated '
              f'on the card and written back under {sorted(cached)}')
        for w in wrappers.values():
            w.launches = 0
        m_eng.warmup((1, 8, 32))
        fusion = MultimodalFusion()
        m_singles = [fusion.predict_multimodal(**r) for r in requests[:4]]
        # the batches the batcher forms depend on the threads' timing:
        # record them, so the cpu twin serves the same batches
        m_groups, serve_batch = [], m_eng.predict_multimodal_batch

        def recorded_batch(rs):
            m_groups.append(list(rs))
            return serve_batch(rs)
        m_eng.predict_multimodal_batch = recorded_batch
        batcher = EngineBatcher(m_eng)
        try:
            m_served = serve_through(batcher.multimodal, requests[4:])
        finally:
            batcher.stop()
            del m_eng.predict_multimodal_batch
        one_image = ImageInference().predict(requests[0]['image_path'])
        one_text = TextInference().predict(TEXTS[0])
        counts = {name: w.launches for name, w in wrappers.items()}
        n_batches = batcher.stats()['multimodal']['batches']
        m_dispatches = 3 + 3 * len(seqs) + 4 + n_batches
        print(f'models engine: {m_dispatches} dispatches of the speech leg '
              f'(3 single-modality warmup, {3 * len(seqs)} rf tri-modal '
              f'warmup, 4 MultimodalFusion requests, {n_batches} batcher); '
              f'launches {counts}')
        for name, n in counts.items():
            want = m_dispatches if name in speech_names else 0
            check(n == want, f'{name} launched {n} times in {m_dispatches} '
                  f'dispatches of the models engine (want {want})')
        for r in m_singles + m_served:
            check(set(r) == {'speech', 'text', 'image', 'fusion'}
                  and r['fusion'].get('method') == 'random_forest'
                  and 'attention_weights' not in r['fusion'],
                  f'rf tri-modal result {r}')
        check(set(one_image) == set(one_text) == {
            'emotion', 'confidence', 'all_probabilities'},
            'facade results')

        # the CPU twin over the same directory takes the card's scales
        t0 = time.perf_counter()
        m_cpu = EmotionEngine.from_models_dir(mdir, device='cpu')
        load_cached = time.perf_counter() - t0
        check(m_cpu._image_scales_cached and m_cpu._bert_scales_cached,
              'the cpu models engine did not take the card\'s scales')
        e_req = {}
        cpu_batched = {id(r): out for g in m_groups
                       for r, out in zip(g, m_cpu.predict_multimodal_batch(g))}
        for what, got, ref in (
                ('single', m_singles, [m_cpu.predict_multimodal(**r)
                                       for r in requests[:4]]),
                ('batched', m_served,
                 [cpu_batched[id(r)] for r in requests[4:]])):
            for mod, band in (('speech', SPEECH_BAND), ('text', TRI_BAND),
                              ('image', MOBILENET_BAND)):
                e_req[f'{what} {mod}'] = check_results(
                    [g[mod] for g in got], [r[mod] for r in ref], band,
                    f'models bf16 {what} {mod}')
        print('models engine: the 8 requests agree with the cpu engine ('
              + ', '.join(f'{k} {v:.3e}' for k, v in e_req.items()) + ')')
        walks = {}

        def rf_tail(k_rows, c_rows, eng, what, bands):
            """The card's rf tails: within 1e-6 of the forest walked on
            the card's own s/t/i; and the cpu engine's tail wherever no
            walk compares an input within its modality's band (bands:
            speech, text, image) of a threshold (such walks may flip a
            branch: counted)."""
            x = torch.from_numpy(np.ascontiguousarray(k_rows[:, :21])).to(dev)
            own = forest_apply(eng.forest['arrays'], x,
                               eng.forest['depth']).cpu().numpy()
            e_own = float(np.abs(k_rows[:, 21:28] - own).max())
            check(e_own <= 1e-6, f'{what}: rf tail vs its own walk {e_own}')
            arrays = {k: v.cpu().numpy()
                      for k, v in eng.forest['arrays'].items()}
            bands = np.repeat(bands, 7)
            near = rows_near = 0
            for b in range(k_rows.shape[0]):
                row_near = False
                for t in range(arrays['feature'].shape[0]):
                    n = 0
                    while arrays['left'][t, n] != n:
                        f = arrays['feature'][t, n]
                        thr = arrays['threshold'][t, n]
                        if abs(k_rows[b, f] - thr) <= bands[f]:
                            row_near = True
                            near += 1
                            break
                        n = arrays['left' if k_rows[b, f] <= thr
                                   else 'right'][t, n]
                rows_near += row_near
                if not row_near:
                    e = float(np.abs(k_rows[b, 21:28]
                                     - c_rows[b, 21:28]).max())
                    check(e <= 1e-6, f'{what}: rf tail row {b} differs from '
                          f'cpu by {e} with no walk near a threshold')
            walks[what] = (near, rows_near, e_own)
            return near, rows_near

        texts5 = TEXTS[:5]
        k_rows = m_eng._run_trimodal(tri_waves[:5], texts5, tri_pics[:5])
        c_rows = m_cpu._run_trimodal(tri_waves[:5], texts5, tri_pics[:5])
        check(k_rows.shape == (5, 28) and bool(np.isfinite(k_rows).all()),
              f'rf packed rows {k_rows.shape}')
        e_parts = {part: float(np.abs(k_rows[:, a:b] - c_rows[:, a:b]).max())
                   for part, a, b in (('speech', 0, 7), ('text', 7, 14),
                                      ('image', 14, 21), ('rf', 21, 28))}
        for part, band in (('speech', SPEECH_BAND), ('text', TRI_BAND),
                           ('image', MOBILENET_BAND)):
            check(e_parts[part] <= band, f'models bf16 {part}: '
                  f'{e_parts[part]} > {band}')
        near, rows_near = rf_tail(k_rows, c_rows, m_eng, 'bf16',
                                  [SPEECH_BAND, TRI_BAND, MOBILENET_BAND])
        labels = {mod: sorted({r[mod]['emotion']
                               for r in m_singles + m_served})
                  for mod in ('speech', 'text', 'image', 'fusion')}
        print(f'models engine: agrees with from_models_dir(device=cpu) '
              f'(scales from the cache, built in {load_cached:.2f} s): B=5 '
              f'packed '
              f'rows by part ' + ', '.join(f'{k} {v:.3e}' for k, v in
                                         e_parts.items())
              + f'; rf tail within {walks["bf16"][2]:.1e} of the forest on '
              f'the card\'s own s/t/i; {rows_near} of 5 rows with a walk '
              f'near a threshold ({near} walks of {5 * n_trees}), the others '
              f'equal to cpu; decisions over 8 requests: {labels}')

        # fp32: a second card engine against the cpu engine
        m32 = EmotionEngine.from_models_dir(mdir, compute_dtype='float32')
        m32_cpu = EmotionEngine.from_models_dir(mdir, compute_dtype='float32',
                                                device='cpu')
        k32 = m32._run_trimodal(tri_waves[:5], texts5, tri_pics[:5])
        c32 = m32_cpu._run_trimodal(tri_waves[:5], texts5, tri_pics[:5])
        e32 = float(np.abs(k32[:, :21] - c32[:, :21]).max())
        check(e32 <= 1e-4, f'models fp32: s/t/i differ from cpu by {e32}')
        _near32, rows_near32 = rf_tail(k32, c32, m32, 'fp32', [1e-4] * 3)
        e32_rf = float(np.abs(k32[:, 21:] - c32[:, 21:]).max())
        print(f'models engine (fp32 parity): the card agrees with device=cpu '
              f'(s/t/i max|err| {e32:.3e} <= 1e-4; rf tail {e32_rf:.3e}, '
              f'{rows_near32} of 5 rows with a walk within 1e-4 of a '
              f'threshold)')
        del m_cpu, m32_cpu
    finally:
        Config.FUSION_MODE, Config.COMPUTE_DTYPE, Config.DFT_PRECISION = saved

    # ------------------------------------------------------------ 6c moe
    moe_launches, moe_dispatches = moe_phase(card, wrappers, tri_waves,
                                             tri_pics)

    # -------------------------------------------------- 6d data-parallel
    dp_phase(card)

    # ------------------------------------- 6e serving DP, model/pipe axes
    dp_serve_launches, dp_serve_dispatches = serve_dp_phase(card, wrappers)
    axes_phase(card)

    # ---------------------------------------------------------- 6f entry
    entry_launches, entry_dispatches = entry_phase(card, wrappers, tri_waves,
                                                   tri_pics)

    # ----------------------------------------------------------- 6g host
    host_launches, host_dispatches = host_phase(
        card, wrappers, tree, scaler, tri_engine, bert_meta, tri['high'],
        engine, requests, tri_waves, tri_pics)

    # ------------------------------------------------------- 6h moonlight
    expert_row = moonlight_phase(card, tree, scaler, img_tree, cpu_meta,
                                 tri_waves, tri_pics)

    # ----------------------------------------------------------- 7 times
    # the models phase first: the MobileNetV2 image step, the rf
    # tri-modal step, the forest walk and MobileNetV2's depthwise conv
    for mode, eng in (('bf16-int8', m_eng), ('fp32', m32)):
        for B in (1, 8, 32):
            wire_dev = eng._to_device(eng._wire_image(pics[:B], B))
            step = cuda_ms(lambda: eng._image_forward(wire_dev), reps=20)
            print(f'time mobilenet_v2 image device step {mode:9s} B={B:2d}: '
                  f'{step:.4f} ms (CUDA events, wire already on the card); '
                  f'{card}')
    for B in (1, 8, 32):
        args = tri_wires(m_eng, B, (TEXTS * 4)[:B])
        step = cuda_ms(lambda: m_eng._trimodal_forward(*args), reps=20)
        wall, busy, share, ops, _top = profile_step(
            lambda: m_eng._trimodal_forward(*args))
        print(f'time rf trimodal device step B={B:2d} seq {args[1].shape[1]}: '
              f'{step:.4f} ms (CUDA events); profiled wall {wall:.3f} ms, '
              f'device busy {busy:.3f} ms, busy share {share:.3f}, '
              f'{ops:.0f} device ops/step; {card}')
    xf = torch.from_numpy(np.random.RandomState(9).dirichlet(
        np.ones(7), (32, 3)).reshape(32, 21).astype(np.float32)).to(dev)
    fa = m_eng.forest['arrays']
    depth = m_eng.forest['depth']
    with torch.inference_mode():
        ev = cuda_ms(lambda: forest_apply(fa, xf, depth))
        dv, n_dv = device_ms(lambda: forest_apply(fa, xf, depth))
        leaves = forest_leaves(fa, xf, depth)
    T = fa['feature'].shape[0]
    # bytes: x read, the visited nodes' feature, threshold, left and right
    # (8 + 4 + 8 + 8 bytes) once a level, each leaf's 7 probabilities,
    # the (B, 7) result
    walk_bytes = xf.numel() * 4 + 32 * T * depth * 28 + 32 * T * 7 * 4 \
        + 32 * 7 * 4
    b_ms, b_by, _peak = bound(walk_bytes, 32 * T * (depth + 7), 'fp32')
    print(f'time forest walk B=32 ({T} trees, depth {depth}, '
          f'{int(torch.unique(leaves).numel())} distinct leaves): {ev:.4f} ms '
          f'by events, {fmt_ms(dv)} on the device ({n_dv} launches a call); '
          f'bound {b_ms:.5f} ms by {b_by}; {card}')
    blk = m_eng.image['model'].block_2.dw_conv
    xd = torch.randn(32, 112, 112, blk.in_channels, dtype=torch.bfloat16,
                     device=dev)
    with torch.inference_mode():
        yd = blk(xd)
        ev = cuda_ms(lambda: blk(xd))
        dv, n_dv = device_ms(lambda: blk(xd))
    b_ms, b_by, _peak = bound(nbytes(xd, yd, blk.weight, blk.bias),
                              2 * yd.numel() * 9, 'fp32')
    print(f'time depthwise conv (block_2.dw_conv, {tuple(xd.shape)} bf16 '
          f'NHWC -> {tuple(yd.shape)}, cuDNN through F.conv2d on the '
          f'channels-last view): {ev:.4f} ms by events, {fmt_ms(dv)} on the '
          f'device ({n_dv} launches a call: conv and bias add); output '
          f'NHWC-contiguous {yd.is_contiguous()}; bound {b_ms:.5f} ms by '
          f'{b_by}; {card}')
    print(f'time from_models_dir host wall (full-width directory, '
          f'{sum(sizes.values()):.0f} MiB of .mecp): {load_first:.2f} s on '
          f'cuda with calibration and write-back, {load_cached:.2f} s on '
          f'the cpu with cached scales; {card}')
    P, mags, residual, pitches, rows, x = inputs32
    stem32, pooled32 = image_inputs32
    timed = {
        'mfcc_mean': (lambda: speech_kernels.mfcc_mean(P),
                      lambda: speech_kernels.mfcc_mean_plain(P)),
        'tuning_select': (
            lambda: tuning_kernel.tuning_select(mags, residual, pitches),
            lambda: tuning_kernel.tuning_select_plain(mags, residual,
                                                      pitches)),
        'rolloff_bins': (lambda: rolloff_kernel.rolloff_bins(rows),
                         lambda: rolloff_kernel.rolloff_bins_plain(rows)),
        'speech_dnn': (lambda: fwd(x),
                       lambda: speech_kernels.speech_dnn_plain(
                           x, fwd.params, fwd.dims)),
        'max_pool_3x3s2': (
            lambda: pool_kernel.max_pool_3x3s2(stem32),
            lambda: pool_kernel.max_pool_3x3s2_plain(stem32)),
        'layer1': (lambda: resnet_kernel.layer1(pooled32, blocks),
                   lambda: resnet_kernel.layer1_plain(pooled32, blocks)),
        'dft_spectrograms': (
            lambda: dft_kernel.dft_spectrograms(frames32, 'highest'),
            lambda: dft_kernel.dft_spectrograms_plain(frames32, 'highest')),
        'dft_spectrograms[bf16]': (
            lambda: dft_kernel.dft_spectrograms(frames32, 'bf16'),
            lambda: dft_kernel.dft_spectrograms_plain(frames32, 'bf16')),
    }
    # one PyTorch call for the same function, where there is one; timed
    # here as a yardstick and used nowhere in the port. K5: one matmul of
    # the frames against both bases side by side (fp32 with TF32 off; for
    # 'bf16' on bf16 tensors, whose result is rounded to bf16: a floor
    # for a library, not the same function). K6: F.max_pool2d, which is
    # also the plain version without its layout copy
    flat32 = frames32.reshape(-1, frames32.shape[-1])
    both = {prec: torch.cat(dft_kernel._bases(dev, prec), 1)
            for prec in dft_kernel.PRECISIONS}
    flat16, both16 = flat32.to(torch.bfloat16), both['bf16'].to(torch.bfloat16)
    stem_nchw = stem32.permute(0, 3, 1, 2)
    library = {
        'dft_spectrograms': lambda: torch.matmul(flat32, both['highest']),
        'dft_spectrograms[bf16]': lambda: torch.matmul(flat16, both16),
        'max_pool_3x3s2': lambda: F.max_pool2d(stem_nchw, 3, stride=2,
                                               padding=1),
    }
    times = {}
    for name, (kern, plain) in timed.items():
        # in turns (plain, library, kernel, kernel, library, plain) so
        # drift hits all alike
        lib = library.get(name)
        order = (plain, lib, kern, kern, lib, plain)
        with torch.inference_mode():
            p1, l1, k1, k2, l2, p2 = (cuda_ms(f) if f else None
                                      for f in order)
            dev_ms, n_dev = device_ms(kern)
        times[name] = (statistics.median([k1, k2]),
                       statistics.median([p1, p2]),
                       statistics.median([l1, l2]) if lib else None, dev_ms)
        lib_ms = f'{times[name][2]:.4f} ms' if lib else 'none'
        print(f'time {name:13s} B=32: kernel {times[name][0]:.4f} ms by '
              f'events, {fmt_ms(dev_ms)} on the device ({n_dev} launches a '
              f'call, torch.profiler), plain {times[name][1]:.4f} ms, '
              f'library call {lib_ms} (medians of {REPS} runs; {card})')

    # the bounds, from the shapes just timed (data-sheet peaks, bound())
    Bt, T, _ = P.shape
    mel = speech_kernels._mel_tables(P.device)[0]
    convs = resnet_kernel._convs(blocks)
    M7 = pooled32.shape[0] * pooled32.shape[1] * pooled32.shape[2]
    M5 = flat32.shape[0]
    dims = fwd.dims
    k5_ops = 4 * M5 * dft_kernel.N_FFT * dft_kernel.N_BINS
    k5_out = 2 * M5 * dft_kernel.N_BINS * 4
    bounds = {
        # the mel filters' nonzero taps, one log per mel and frame, and
        # the DCT of the time mean
        'mfcc_mean': bound(
            nbytes(P) + Bt * 40 * 4,
            2 * int((mel != 0).sum()) * Bt * T + Bt * T * mel.shape[0]
            + 2 * mel.shape[0] * 40 * Bt, 'fp32'),
        # the reference's 32 bisection probes and 101 histogram edges, one
        # compare each (the kernel's radix route does fewer; bytes bind)
        'tuning_select': bound(
            nbytes(mags, residual, pitches) + Bt * 5,
            (32 + 101) * mags.numel(), 'fp32'),
        # the row total and the prefix sum
        'rolloff_bins': bound(nbytes(rows) + rows.shape[0] * 4,
                              2 * rows.numel(), 'fp32'),
        'speech_dnn': bound(
            nbytes(x, fwd.params) + x.shape[0] * 128 * 4,
            2 * x.shape[0] * sum(a * b for a, b in zip(dims, dims[1:])),
            'fp32'),
        'dft_spectrograms': bound(
            nbytes(flat32, *dft_kernel.kernel_tables(flat32.device, 'highest'))
            + k5_out,
            k5_ops, 'fp32'),
        'dft_spectrograms[bf16]': bound(
            nbytes(flat32, *dft_kernel.kernel_tables(flat32.device, 'bf16'))
            + k5_out,
            k5_ops, 'bf16_tc'),
        'max_pool_3x3s2': bound(nbytes(stem32, pooled32), 8 * pooled32.numel(),
                                'fp32'),
        'layer1': bound(
            nbytes(pooled32, *(t for c in convs for t in (
                c.kernel_q, c.kernel_scale, c.bias, c.act_scale)))
            + M7 * 256 * 2,
            2 * M7 * sum(c.kernel_q.numel() for c in convs), 'int8_tc'),
    }
    def bound_share(b_ms, dev_ms):
        return None if dev_ms is None else b_ms / dev_ms

    for name, (ms, by, peak) in bounds.items():
        dev_share = bound_share(ms, times[name][3])
        print(f'bound {name:13s} B=32: {ms:.5f} ms, bound by {by} ({peak} '
              f'peak of the H100 SXM data sheet); share of the kernel\'s '
              f'device time '
              + ('not measured' if dev_share is None else f'{dev_share:.3f}')
              + f' (of its event time {ms / times[name][0]:.3f})')
    for mode, eng in (('bf16', engine), ('fp32 parity', parity)):
        for B in (1, 8, 32):
            wire_dev = eng._to_device(eng._wire_waves(clips[:B], B))
            step = cuda_ms(lambda: eng._speech_forward(wire_dev))
            host = []
            for _ in range(10):
                t0 = time.perf_counter()
                eng._run_speech(clips[:B])
                host.append((time.perf_counter() - t0) * 1e3)
            print(f'time engine device step {mode:11s} B={B:2d}: {step:.4f} '
                  f'ms (CUDA events, wire already on the card); _run_speech '
                  f'host wall {statistics.median(host):.2f} ms (median of 10,'
                  f' incl. wire encode + copies); {card}')
    for mode, eng in (('bf16-int8', img_engine), ('fp32', img32)):
        for B in (1, 8, 32):
            wire_dev = eng._to_device(eng._wire_image(pics[:B], B))
            step = cuda_ms(lambda: eng._image_forward(wire_dev), reps=20)
            host = []
            for _ in range(10):
                t0 = time.perf_counter()
                eng.predict_images(pics[:B])
                host.append((time.perf_counter() - t0) * 1e3)
            print(f'time image device step {mode:9s} B={B:2d}: {step:.4f} ms '
                  f'(CUDA events, wire already on the card); predict_images '
                  f'host wall {statistics.median(host):.2f} ms (median of 10,'
                  f' incl. wire encode + copies); {card}')

    tri_step = {}
    for prec, eng in tri.items():
        for B in (1, 8, 32):
            args = tri_wires(eng, B, (TEXTS * 4)[:B])
            step = cuda_ms(lambda: eng._trimodal_forward(*args), reps=20)
            tri_step[prec, B] = step
            print(f'time trimodal device step {prec:7s} B={B:2d} seq '
                  f'{args[1].shape[1]}: {step:.4f} ms (CUDA events, wire '
                  f'already on the card); {card}')
    eng = tri['high']
    for B in (1, 32):
        for s in seqs:
            ids = torch.randint(5, 30522, (B, s), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(s)
                                ).to(dev)
            mask = torch.ones_like(ids)
            step = cuda_ms(lambda: eng._text_forward(ids, mask), reps=20)
            print(f'time text device step B={B:2d} seq {s:3d}: {step:.4f} ms '
                  f'(CUDA events, BERT-base bf16 int8 static); {card}')
    req = dict(requests[0])
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        eng.predict_multimodal(**req)
        host.append((time.perf_counter() - t0) * 1e3)
    print(f'time predict_multimodal B=1 host wall: '
          f'{statistics.median(host):.2f} ms (median of 10: WAV + PNG decode, '
          f'tokenize, wire encode, copies, device step, result dicts); {card}')
    for prec, B in (('high', 1), ('high', 32), ('highest', 32)):
        args = tri_wires(tri[prec], B, (TEXTS * 4)[:B])
        wall, busy, share, ops, top = profile_step(
            lambda: tri[prec]._trimodal_forward(*args))
        print(f'profile trimodal {prec:7s} B={B:2d}: wall {wall:.3f} ms '
              f'(synced step, median of 10), device busy {busy:.3f} ms, '
              f'busy share {share:.3f}, {ops:.0f} device ops/step; {card}')
        for name, ms in top:
            print(f'  {ms:8.4f} ms  {name}')

    # ------------------------------------------------------- 7b roofline
    chains = roofline_phase(card, timed, times, tri['high'], requests[0],
                            tri_step['high', 32], tri_wires(
                                tri['high'], 32, (TEXTS * 4)[:32]))
    tmp.cleanup()
    models_tmp.cleanup()

    # ---------------------------------------------------------- 8 report
    sources = {'mfcc_mean': ('mec_tpu_torch/csrc/mfcc_mean.cu',
                             'mec_tpu/ops/pallas_kernels.py:211'),
               'tuning_select': ('mec_tpu_torch/csrc/tuning_select.cu',
                                 'mec_tpu/ops/pallas_tuning.py:116'),
               'rolloff_bins': ('mec_tpu_torch/csrc/rolloff_bins.cu',
                                'mec_tpu/ops/pallas_rolloff.py:71'),
               'speech_dnn': ('mec_tpu_torch/csrc/speech_dnn.cu',
                              'mec_tpu/ops/pallas_kernels.py:286'),
               'max_pool_3x3s2': ('mec_tpu_torch/csrc/max_pool_3x3s2.cu',
                                  'mec_tpu/ops/pallas_pool.py:63'),
               'layer1': ('mec_tpu_torch/csrc/layer1_int8.cu',
                          'mec_tpu/ops/pallas_resnet.py:189'),
               'dft_spectrograms': ('mec_tpu_torch/csrc/dft_power.cu',
                                    'mec_tpu/ops/pallas_kernels.py:99')}
    # launches: the tri-modal paths' runs (both dense engines, phase 6,
    # and the MoE engine, phase 6c: launches_by_path splits them);
    # launches_per_dispatch: in the 'highest' engine, where all seven are
    # on the path; moe_launches_per_dispatch on the MoE tri-modal path.
    # K5's times are the 'highest' precision's; its 'bf16' ones follow
    # under bf16_* keys. bound_by says which side
    # binds, bound_peak which data-sheet peak, share is bound_ms over
    # device_ms. The bf16 library call rounds its result to bf16: a
    # floor, not the same function
    def entry(name):
        ms, plain_ms, lib_ms, dev_ms = times[name]
        b_ms, b_by, b_peak = bounds[name]
        e = {'name': name, 'route': 'cuda', 'source': sources[name][0],
             'replaces': sources[name][1],
             'launches': (tri_launches[name] + moe_launches[name]
                          + dp_serve_launches[name] + entry_launches[name]
                          + host_launches[name]),
             'launches_by_path': {'trimodal': tri_launches[name],
                                  'moe_trimodal': moe_launches[name],
                                  'serve_dp': dp_serve_launches[name],
                                  'entry_http': entry_launches[name],
                                  'host_features': host_launches[name]},
             'host_features_dispatches': host_dispatches,
             'serve_dp_launches_per_dispatch': dp_serve_launches[name]
             / dp_serve_dispatches,
             'entry_launches_per_dispatch': entry_launches[name]
             / entry_dispatches,
             'launches_per_dispatch': per_dispatch[name],
             'moe_launches_per_dispatch': moe_launches[name]
             / moe_dispatches,
             'max_abs_err': errs[name], 'ms': ms, 'device_ms': dev_ms,
             'plain_ms': plain_ms,
             'bound_ms': b_ms, 'bound_by': b_by, 'bound_peak': b_peak,
             'share': bound_share(b_ms, dev_ms), 'library_ms': lib_ms,
             'chain_ms': chains[name]}
        if name == 'dft_spectrograms':
            ms, plain_ms, lib_ms, dev_ms = times[name + '[bf16]']
            b_ms, b_by, b_peak = bounds[name + '[bf16]']
            e.update(bf16_ms=ms, bf16_device_ms=dev_ms,
                     bf16_chain_ms=chains[name + '[bf16]'],
                     bf16_plain_ms=plain_ms, bf16_bound_ms=b_ms,
                     bf16_bound_by=b_by, bf16_bound_peak=b_peak,
                     bf16_share=bound_share(b_ms, dev_ms),
                     bf16_library_ms=lib_ms)
        return e

    print(f'chip_smoke total wall: {time.perf_counter() - t_start:.1f} s; '
          f'{card}')
    print(card)
    print(json.dumps({'kernels': [entry(name) for name in wrappers]
                      + [expert_row]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
