"""The inference engine: the port of mec_tpu's EmotionEngine.

Same method names and results as mec_tpu/serving/engine.py, so the web
app (`create_app(engine=...)`) and the micro-batcher drive it unchanged:

  speech: waveforms -> wire (bf16: packed 12-bit PCM, or PCM16 with
    MEC_WIRE_COMPRESS=0; fp32: float32 samples) -> device -> 56-dim
    frontend -> standardize -> speech DNN -> packed [probs | penult].
    bf16 serving graph: the hop-slab frontend, or with
    MEC_DFT_PRECISION=highest|bf16 the framed one on K5; K1 mfcc_mean,
    K2 tuning_select, K3 rolloff_bins; the fused BN-folded DNN (K4).
    fp32 parity graph, the reference's (its engine turns the Pallas
    path off in fp32): rFFT STFT, MFCC by two matmuls, K2, the cumsum
    rolloff, and the plain SpeechDNN with live BatchNorm
  text: texts -> WordPiece ids/mask (host) sliced to a sequence bucket
    -> BERT (bf16: tanh GELU, int8 encoder matmuls with static scales;
    fp32: erf GELU) -> packed [probs | CLS]; a BERT whose config.json
    has num_experts serves its mixture-of-experts FFN (models/moe.py:
    per-example top-1 routing with the capacity of the bucket's padded
    length, as in JAX; in bf16 only the attention matmuls are int8)
  text, text_arch='moonlight' (serving/text_moonlight.py): the same
    WordPiece ids -> Moonlight-16B-A3B (models/moonlight.py: MLA, the
    dropless top-6 expert layers on the grouped expert GEMM kernel) ->
    packed [probs | last real token's hidden state]; its routing
    counters ride out of the tri-modal step as two more columns of the
    packed rows and are recorded a dispatch (text.moe.experts_touched,
    text.moe.routed_pairs: means over the expert layers)
  image: uint8 RGB -> YUV 4:2:0 wire (bf16) or raw uint8 (fp32) ->
    device -> decode + ImageNet normalize -> ResNet50 (bf16: BN folded,
    stem pool K6, int8 bottleneck convs with static scales, layer1 K7;
    fp32: live BN, fp32 convs, plain pool) -> packed [probs | feat]
  image, MobileNetV2 (an artifact whose params hold 'conv_stem'): the
    same wire and forms (bf16: BN folded, the 1x1 expand/project convs
    and conv_head int8 static, depthwise 3x3s in bf16; fp32: live BN)
  tri-modal: the three encoders and the attention fusion in one device
    step -> one packed (B, 34) row [s 7 | t 7 | i 7 | fusion 7 | attn 3 |
    decision 3]; with MEC_FUSION_MODE=rf and a forest, the forest's walk
    over the three softmax outputs instead -> (B, 28) [s | t | i | rf 7]
  -> result dicts

Batches pad up to Config.BATCH_BUCKETS, as in the JAX engine. Serving
data parallelism (the JAX engine's mesh, engine.py:112-127) is asked
for: mesh=None (the default) serves one device; with mesh='auto' and a
CUDA device without an index while more than one card is visible, the
engine holds one replica of every served model on each card of the data
axis (parallel/mesh.local_mesh_shape: MEC_MESH_DATA, MEC_MESH_MODEL; a
model column's cards would compute the same rows, so the first card of
each serves, as the JAX engine replicates the params over 'model'), and
a device with an index ('cuda:1') stays that one card; an explicit
device list is used as given (two replicas may share a card; a card
that is not visible raises). The static int8 scales are calibrated once, on the
first device, and every replica is a copy of that one's models. The
bucket rounds up to a multiple of the replica count, the padded batch
splits into contiguous row blocks, one a replica, each device step runs
on its block (all replicas' launches are queued from the calling thread
before any result is fetched, so the cards overlap) and the packed rows
are gathered back in order. The device
is explicit and never auto-detected; on 'cpu' every kernel wrapper runs
its plain PyTorch version, on 'cuda' the hand-written kernels. Nothing
is caught around the device work: where the JAX engine logs and serves
a weaker mode (a failed BN fold, int8 quantization or static
calibration; a failed fused tri-modal step, which it re-serves per
modality), this one raises. The K3 rolloff search stays on in the fused
step (the JAX fused graph turned it off as a TPU custom-call
workaround). A missing model serves the reference's fallbacks (speech:
the heuristic ladder; text: the keyword map; image: neutral; fusion:
the weighted average), and an undecodable upload takes the reference's
fallback ladder (speech: that request; image: the whole batch; a
tri-modal request: per-modality results and the weighted fusion), as
the JAX engine does. predict_texts_lstm serves the Bi-LSTM text model
(KerasTokenizer ids padded to the batch bucket -> models.bilstm in the
compute dtype -> result dicts), or the keyword map without one, as in
JAX.

EmotionEngine.from_models_dir (and get_engine, the process-wide
singleton) reads a models directory as the JAX engine's _load_all does,
with convert/store.py in place of flax: the speech DNN and its scaler,
bert_model/ (bert_model.mecp, config.json, vocab.txt), the Bi-LSTM
(text_model.mecp with its text_model_tokenizer.json or .pkl), the image
model (ResNet50 or MobileNetV2, its meta's img_size and int8_scales),
the fusion net, and in rf mode the forest. Each artifact is its .mecp
when there is one; else the reference-format artifact beside it (.h5,
.pt, .pkl, an HF BERT directory) is converted (convert/, the JAX
converters' copies) and cached as that .mecp, a scaler .pkl as its .npz,
for the next load. Static int8 scales calibrated at load are written
back into the artifact's meta under the JAX engine's keys, so either
engine built next skips the calibration. Deviations from the JAX loader:
  * a missing artifact serves its fallback, as in JAX;
  * a corrupt .mecp, an invalid forest or a failed conversion (h5py or
    joblib missing, a truncated file) raises, where JAX logs and
    degrades;
  * the scaler .pkl is cached as its .npz (JAX reads the .pkl at every
    load);
  * a read-only models directory keeps the new scales in memory only
    (logged); any other failure to write them raises.

The kernel switches (Config.USE_PALLAS, PALLAS_TUNING, PALLAS_ROLLOFF)
have the JAX package's scope: USE_PALLAS=0 puts the bf16 speech leg on
the parity graph (K1, K3, K4, K5 off; the compressed wire stays), the
other two turn off K2 and K3 alone (ops/audio_features.py); the engine
logs which kernels a flag turned off.

MEC_HOST_AUDIO_FEATURES (Config.HOST_AUDIO_FEATURES) is resolved as in
the JAX engine (engine.py:128-146): in bf16 it is on for 1/true/yes/on,
and for 'auto' (the default) on a host with >= 4 CPUs whose C++
featurizer g++ built; fp32 parity mode never uses it. With it on, the
speech wire is the (bucket, 56) float32 features computed on the host
(native/featurizer.py::extract56, or ops/host_features.features_56_np
without g++), and the speech step standardizes them and runs the DNN
(K4 in bf16) with no device frontend: K1, K2, K3 and K5 are not
launched. The engine logs at build which audio wire it chose and why.
The wire encoders (12-bit PCM, YUV 4:2:0) and the WordPiece tokenizer
run the C++ loops of native/ where g++ is found, as in JAX.

The engine times its own phases on the process-wide StageTimer
(utils/profiling.py; /api/metrics shows them, and with the timer's log
on each is kept with its interval, thread and parent):
  request.decode (.speech, .image)   predecode_multimodal, in the
                                     request's thread
  trimodal.dispatch                  a tri-modal dispatch: the whole of
                                     predict_multimodal_batch, or of a
                                     fused batch-1 request
    trimodal.decode_stage_ms         the batch's remaining decodes
    trimodal.wire_encode (.speech, .text, .image)
                                     the three wires, row-padded
    trimodal.dispatch_fetch          _run alone
    trimodal.result_unpack           result dicts and the degraded ladder
  engine.load.text                   the text leg's load (BERT:
                                     quantization and calibration)
  step.h2d, step.launch, step.fetch  every _run: the copies in, the step
                                     method's launches (in an eager
                                     tri-modal step: .speech, .text,
                                     .image, .fusion), the rows back
    step.replay                      inside step.launch, when the step
                                     replays its CUDA graph

On a card, warmup captures the tri-modal step into one CUDA graph a
(batch bucket, sequence bucket) on every replica (serving/graphs.py), and
_run replays the graph whose argument shapes and dtypes match, in place
of the step's ~2,000-2,500 eager launches; every other call (the CPU, an
uncaptured shape, the single-modality steps) runs eagerly. Replacing
weights or static scales drops the graphs; the next warmup captures them
again.
"""

from __future__ import annotations

import copy
import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.from_jax import (bert_state_from_jax,
                                            forest_from_jax,
                                            fusion_state_from_jax,
                                            image_state_from_jax,
                                            lstm_state_from_jax,
                                            speech_state_from_jax,
                                            speech_widths)
from mec_tpu_torch.convert.hf_config import (model_kwargs_from_config,
                                             read_config)
from mec_tpu_torch.image.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                            load_image_uint8)
from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.models.bilstm import BiLSTMTextModel
from mec_tpu_torch.models.forest import forest_apply
from mec_tpu_torch.models.fusion import MultiModalFusionModel
from mec_tpu_torch.models.mobilenet import MobileNetV2EmotionModel
from mec_tpu_torch.models.resnet import ImageEmotionModel
from mec_tpu_torch.models.speech_dnn import SpeechDNN
from mec_tpu_torch.native import featurizer
from mec_tpu_torch.native.tokenizer import accelerate
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import wav
from mec_tpu_torch.ops.dft_kernel import PRECISIONS
from mec_tpu_torch.ops.fold import fold_conv_bn
from mec_tpu_torch.ops.quant import (calibrate_static_scales,
                                     extract_static_scales,
                                     insert_static_scales,
                                     quantize_bert_params,
                                     quantize_image_params)
from mec_tpu_torch.ops.speech_kernels import make_speech_dnn
from mec_tpu_torch.parallel.mesh import local_mesh_shape
from mec_tpu_torch.serving import wire
from mec_tpu_torch.serving.graphs import StepGraphs
from mec_tpu_torch.serving.text_moonlight import MoonlightText
from mec_tpu_torch.text.cleaning import clean_text
from mec_tpu_torch.text.keras_tokenizer import KerasTokenizer
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer
from mec_tpu_torch.utils.profiling import timer as stage_timer

log = logging.getLogger('mec_tpu_torch.serving')

EMOTIONS = Config.EMOTIONS
N_FEATURES = 56

# Keyword fallback map (reference text_inference.py:12-20)
KEYWORD_MAP = {
    'happy': ['happy', 'joy', 'glad', 'pleased', 'delighted', 'cheerful',
              'love', 'excited'],
    'sad': ['sad', 'down', 'unhappy', 'depressed', 'blue', 'disappointed',
            'heartbroken'],
    'angry': ['angry', 'mad', 'furious', 'rage', 'annoyed', 'irritated',
              'frustrated'],
    'fear': ['scared', 'afraid', 'fear', 'terrified', 'anxious', 'nervous',
             'worried'],
    'disgust': ['disgust', 'gross', 'nasty', 'revolting', 'sick'],
    'surprise': ['surprised', 'amazed', 'astonished', 'wow', 'shocked'],
    'neutral': [],
}

# the BertForSequenceClassification fields the port builds (the MoE
# ones from a config.json written by train-text-bert --experts)
_BERT_FIELDS = ('vocab_size', 'hidden_size', 'num_layers', 'num_heads',
                'intermediate_size', 'max_position', 'type_vocab_size',
                'num_classes', 'num_experts', 'moe_capacity_factor')
_FUSION_FIELDS = ('speech_dim', 'text_dim', 'image_dim', 'num_classes',
                  'hidden_dim')
# the text legs by architecture: BERT (bert_* keywords; its code is this
# module's) and Moonlight-16B-A3B (text_* keywords;
# serving/text_moonlight.py)
TEXT_ARCHS = ('bert', 'moonlight')
# the tri-modal step's packed row: [s 7 | t 7 | i 7 | fusion 7 | attn 3 |
# decision 3] with the attention fusion, [s | t | i | rf 7] with the forest
_TRIMODAL_COLS = {'attention': 34, 'rf': 28}


def heuristic_probs(label: str) -> List[float]:
    """The 0.9 / uniform-0.1 split used by every reference fallback."""
    probs = np.ones(len(EMOTIONS)) * (0.1 / (len(EMOTIONS) - 1))
    probs[EMOTIONS.index(label)] = 0.9
    return probs.tolist()


def result_dict(probs: Sequence[float]) -> Dict[str, Any]:
    probs = [float(p) for p in probs]
    idx = int(np.argmax(probs))
    return {'emotion': EMOTIONS[idx], 'confidence': float(probs[idx]),
            'all_probabilities': probs}


def _fallback(label: str) -> Dict[str, Any]:
    probs = heuristic_probs(label)
    return {'emotion': label, 'confidence': float(max(probs)),
            'all_probabilities': probs, '_fallback': True}


def _bucket_for(n: int) -> int:
    for b in Config.BATCH_BUCKETS:
        if n <= b:
            return b
    return int(np.ceil(n / Config.BATCH_BUCKETS[-1])) * Config.BATCH_BUCKETS[-1]


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.zeros((n - x.shape[0],) + x.shape[1:], dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}

# the image architectures, by the JAX engine's scale-cache name
_IMAGE_MODELS = {'resnet50': ImageEmotionModel,
                 'mobilenet_v2': MobileNetV2EmotionModel}


def _load_native_or(ref_path: str, convert_fn) -> Optional[Dict[str, Any]]:
    """The .mecp beside a reference-format artifact, loaded ({'variables',
    'meta'}); else the artifact converted by convert_fn (a tree, or a
    (tree, meta) pair) and cached as that .mecp, passing over an OSError
    on write (a read-only models directory), as the JAX engine's
    _load_native_or (engine.py:229-251) does; None when neither file
    exists. A corrupt .mecp and a failed conversion raise (C5)."""
    nat = store.native_path(ref_path)
    if os.path.exists(nat):
        loaded = store.load_params(nat)
        loaded['meta'] = loaded.get('meta') or {}
        return loaded
    if not os.path.exists(ref_path):
        return None
    converted, meta = convert_fn(ref_path), {}
    if isinstance(converted, tuple):
        converted, meta = converted
    _save_cache(ref_path, nat, lambda: store.save_params(nat, converted,
                                                         meta=meta))
    return {'variables': converted, 'meta': meta}


def _save_cache(ref_path: str, cache: str, write) -> None:
    """write() the cache of a converted artifact; on a read-only models
    directory (OSError) the conversion serves uncached, as in JAX."""
    try:
        write()
    except OSError as e:
        log.warning('converted %s; the cache %s not written: %s', ref_path,
                    cache, e)


def make_parity_speech_dnn(variables: Dict, device):
    """The plain SpeechDNN with live BatchNorm over the Flax tree, on
    `device`: fn(x (B, 56)) -> (B, 7 + 64) [probs | penult], with
    .n_classes and .penult_dim like the fused kernel's forward
    (ops.speech_kernels.make_speech_dnn), which the bf16 graph takes."""
    p = variables['params']
    widths = speech_widths(variables)
    model = SpeechDNN(in_dim=int(np.shape(p['dense_0']['kernel'])[0]),
                      num_classes=int(np.shape(p['dense_out']['kernel'])[1]),
                      widths=widths)
    model.load_state_dict(speech_state_from_jax(variables))
    model = model.to(device).eval().requires_grad_(False)

    def forward(x: torch.Tensor) -> torch.Tensor:
        return torch.cat(model(x), dim=-1)

    forward.n_classes = model.out.out_features
    forward.penult_dim = widths[-1]
    forward.model = model
    return forward


def resolve_mesh(mesh, device: torch.device) -> List[torch.device]:
    """The data replicas' devices (the JAX engine's mesh argument): None
    -> [device]; 'auto' -> the first card of each data row of
    local_mesh_shape over the visible cards when device is a CUDA device
    with no index and more than one card is visible, else [device] (a
    card named by its index stays the one card: the caller chose it); a
    sequence of devices as given, each checked to exist."""
    if mesh is None:
        return [device]
    if isinstance(mesh, str):
        if mesh != 'auto':
            raise ValueError(f"mesh {mesh!r}: expected 'auto', None or a "
                             f'list of devices')
        n = (torch.cuda.device_count()
             if device.type == 'cuda' and device.index is None else 1)
        if n <= 1:
            return [device]
        data, model = local_mesh_shape(n)
        return [torch.device('cuda', d * model) for d in range(data)]
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError('mesh: an empty device list')
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for d in devices:
        if d.type == 'cuda' and (d.index or 0) >= visible:
            raise RuntimeError(
                f'mesh names {d} and {visible} CUDA '
                f'{"device is" if visible == 1 else "devices are"} visible: '
                f'the data axis is never shrunk')
        if d.type not in ('cuda', 'cpu'):
            raise ValueError(f'unsupported device {d}')
    return [torch.device('cuda', torch.cuda.current_device())
            if d.type == 'cuda' and d.index is None else d for d in devices]


def _move(x, device: torch.device):
    """A replica's copy of a device-resident value: modules deep-copied
    onto `device`, tensors copied there, containers walked; host values
    (numpy trees, metas) shared."""
    if isinstance(x, torch.nn.Module):
        return copy.deepcopy(x).to(device)
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _move(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_move(v, device) for v in x)
    return x


class EmotionEngine:
    """Owns the speech, text, image and fusion parameters on one device
    (a replica on each device of its mesh) and serves batches."""

    WEIGHTS = [0.3, 0.35, 0.35]  # speech, text, image (reference :23)
    IMAGE_FALLBACK_LABEL = 'neutral'

    def __init__(self, speech_variables: Optional[Dict] = None,
                 scaler: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 *, image_variables: Optional[Dict] = None,
                 image_meta: Optional[Dict] = None,
                 bert_variables: Optional[Dict] = None,
                 bert_kwargs: Optional[Dict] = None,
                 bert_vocab: Union[Dict[str, int], WordPieceTokenizer,
                                   None] = None,
                 bert_meta: Optional[Dict] = None,
                 text_arch: str = 'bert',
                 text_variables: Optional[Dict] = None,
                 text_kwargs: Optional[Dict] = None,
                 text_vocab: Union[Dict[str, int], WordPieceTokenizer,
                                   None] = None,
                 fusion_variables: Optional[Dict] = None,
                 fusion_config: Optional[Dict] = None,
                 forest_arrays: Optional[Dict] = None,
                 forest_meta: Optional[Dict] = None,
                 lstm_variables: Optional[Dict] = None,
                 lstm_tokenizer: Optional[KerasTokenizer] = None,
                 artifact_paths: Optional[Dict[str, str]] = None,
                 compute_dtype: Optional[str] = None, device,
                 mesh: Any = None):
        """Parameters are the JAX package's Flax trees of numpy arrays;
        a modality whose tree is None serves its fallback.

        speech_variables ({'params', 'batch_stats'} SpeechDNN) and
        scaler ((mean, scale), each (56,); None is the identity).
        image_variables ({'params', 'batch_stats'} ResNet50, or
        MobileNetV2 when the params hold 'conv_stem') and image_meta
        ('img_size', and 'int8_scales', the JAX package's static-scale
        cache, honoured by key). bert_variables ({'params'}
        BertForSequenceClassification), bert_kwargs (its widths, as the
        JAX engine reads them from config.json), bert_vocab (a
        WordPiece vocab {token: id} or a WordPieceTokenizer; without one
        the text model is disabled, as the JAX engine disables it
        without vocab.txt) and bert_meta ('int8_scales').
        text_arch names the text leg: 'bert' (the bert_* keywords) or
        'moonlight' (text_variables: a tree of compute-dtype tensors
        on the device, models/moonlight.py's layout, kept as given;
        text_kwargs: its deepseek_v3 config and num_labels; text_vocab:
        a WordPiece vocab or tokenizer).
        fusion_variables ({'params'} MultiModalFusionModel) and
        fusion_config (its dims). forest_arrays and forest_meta (the
        random-forest fusion, mec_tpu/models/forest.py layout; served in
        the tri-modal step when Config.FUSION_MODE is 'rf').
        lstm_variables ({'params'} BiLSTMTextModel, its widths read from
        the tree) and lstm_tokenizer (its KerasTokenizer; both or
        neither).
        artifact_paths: the .mecp files the trees were read from
        ('image', 'bert': new static scales are written back into their
        meta). compute_dtype: 'bfloat16'
        (serving mode: compressed wires, the hand-written kernels,
        folded BN, int8) or 'float32' (parity mode: the reference's fp32 graph,
        whose speech leg is the rFFT frontend of
        audio_features_56(precision='parity') and the live-BN
        SpeechDNN); None reads Config.COMPUTE_DTYPE. device: 'cpu' or 'cuda[:n]', never
        guessed. mesh: None (one device), 'auto' or a device list
        (resolve_mesh); the first device builds and calibrates, the
        others get copies."""
        devices = resolve_mesh(mesh, torch.device(device))
        self.device = devices[0]
        if self.device.type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' but no CUDA device is "
                                   'available')
        elif self.device.type != 'cpu':
            raise ValueError(f'unsupported device {self.device}')
        name = compute_dtype or Config.COMPUTE_DTYPE
        if name not in _DTYPES:
            raise ValueError(f'compute_dtype {name!r}: expected one of '
                             f'{sorted(_DTYPES)}')
        self.compute_dtype = _DTYPES[name]
        self._dtype_name = name
        # the speech frontend, fixed at load as the JAX engine fixes it at
        # trace time: Config.DFT_PRECISION in bf16 serving mode; fp32
        # parity mode runs the reference's parity graph (rFFT STFT, cumsum
        # rolloff) whatever it says
        # (MEC_USE_PALLAS=0 puts bf16 on the parity graph too, as the
        # JAX engine's use_pallas=False does)
        bf16 = self.compute_dtype == torch.bfloat16
        self._speech_kernels = bf16 and Config.USE_PALLAS
        self._dft_precision = (Config.DFT_PRECISION if self._speech_kernels
                               else 'parity')
        off = ((['K1 mfcc_mean', 'K3 rolloff_bins', 'K4 speech_dnn',
                 'K5 dft_spectrograms'] if bf16 and not Config.USE_PALLAS
                else [])
               + ([] if Config.PALLAS_TUNING else ['K2 tuning_select'])
               + (['K3 rolloff_bins'] if self._speech_kernels
                  and not Config.PALLAS_ROLLOFF else []))
        if off:
            log.warning('kernels turned off by MEC_USE_PALLAS, '
                        'MEC_PALLAS_TUNING or MEC_PALLAS_ROLLOFF: %s',
                        ', '.join(off))
        self._host_audio = self._resolve_host_audio()
        if self._dft_precision not in ('high', 'parity') + PRECISIONS:
            raise ValueError(f'MEC_DFT_PRECISION {self._dft_precision!r}: '
                             'expected high, highest or bf16')
        self.speech: Optional[Dict[str, Any]] = None
        self.image: Optional[Dict[str, Any]] = None
        self.bert: Optional[Dict[str, Any]] = None
        self.fusion: Optional[Dict[str, Any]] = None
        self.forest: Optional[Dict[str, Any]] = None
        self.lstm = self.lstm_tokenizer = None
        self.bert_tokenizer: Optional[WordPieceTokenizer] = None
        paths = dict(artifact_paths or {})
        self._image_native_path = paths.get('image')
        self._bert_native_path = paths.get('bert')
        self._decode_pool = None
        self._decode_pool_lock = threading.Lock()
        # the captured steps (warmup, _capture); replicas are added last
        self._graphs = StepGraphs()
        self.replicas: List['EmotionEngine'] = [self]
        # the last fused batch-1 request's phases (ms), written by
        # _predict_trimodal_fused (JAX engine.py:181)
        self._last_b1_phases: Dict[str, float] = {}
        if speech_variables is not None:
            if scaler is None:
                scaler = (np.zeros(N_FEATURES, np.float32),
                          np.ones(N_FEATURES, np.float32))
            mean, scale = (torch.from_numpy(np.asarray(a, np.float32)
                                            .reshape(N_FEATURES))
                           .to(self.device) for a in scaler)
            self.speech = {'dnn': self._make_dnn(speech_variables,
                                                 self.device),
                           'scaler': (mean, scale),
                           'variables': speech_variables}
        self._image_size = tuple(Config.IMAGE_SIZE)
        self._image_folded = self._image_quant = False
        self._image_quant_mode = 'dynamic'
        self._image_scales_cached = False
        if image_variables is not None:
            self._load_image(image_variables, dict(image_meta or {}))
        self._bert_quant = False
        self._bert_quant_mode = 'dynamic'
        self._bert_scales_cached = False
        self.text_leg: Optional[MoonlightText] = None
        if text_arch not in TEXT_ARCHS:
            raise ValueError(f'text_arch {text_arch!r}: expected one of '
                             f'{TEXT_ARCHS}')
        if text_arch != 'moonlight' and text_variables is not None:
            raise ValueError("text_variables are the 'moonlight' leg's; "
                             'BERT takes bert_variables')
        if text_variables is not None:
            with stage_timer.span('engine.load.text'):
                self.text_leg = MoonlightText(
                    text_variables, dict(text_kwargs or {}), text_vocab,
                    self.device, self.compute_dtype)
        elif bert_variables is not None:
            with stage_timer.span('engine.load.text'):
                self._load_bert(bert_variables, dict(bert_kwargs or {}),
                                bert_vocab, dict(bert_meta or {}))
        if fusion_variables is not None:
            cfg = {k: v for k, v in (fusion_config or {}).items()
                   if k in _FUSION_FIELDS}
            model = MultiModalFusionModel(**cfg, dtype=self.compute_dtype)
            model.load_state_dict(fusion_state_from_jax(fusion_variables))
            self.fusion = {'model': model.to(
                self.device).eval().requires_grad_(False)}
        if lstm_variables is not None:
            p = lstm_variables['params']
            lstm = BiLSTMTextModel(
                vocab_size=np.shape(p['embedding']['embedding'])[0],
                embed_dim=np.shape(p['embedding']['embedding'])[1],
                lstm_units=tuple(np.shape(p[f'bilstm_{i}']['forward']
                                          ['recurrent_kernel'])[0]
                                 for i in (1, 2)),
                dense_units=tuple(np.shape(p[f'dense_{i}']['kernel'])[1]
                                  for i in (1, 2)),
                num_classes=np.shape(p['output']['kernel'])[1],
                dtype=self.compute_dtype)
            lstm.load_state_dict(lstm_state_from_jax(lstm_variables))
            self.lstm = {'model': lstm.to(self.device).eval()
                         .requires_grad_(False)}
            self.lstm_tokenizer = lstm_tokenizer
        if forest_arrays is not None:
            meta = dict(forest_meta or {})
            classes = self._validate_forest(meta)
            self.forest = {'arrays': forest_from_jax(forest_arrays,
                                                     self.device),
                           'depth': int(meta['depth']), 'classes': classes,
                           'index': torch.tensor(classes, device=self.device)}
        # the fusion backend (JAX engine.py:505-513): the forest in rf
        # mode when one is loaded, else the attention net
        self._fusion_kind: Optional[str] = None
        if Config.FUSION_MODE == 'rf' and self.forest is not None:
            self._fusion_kind = 'rf'
        elif self.fusion is not None:
            self._fusion_kind = 'attention'
            if Config.FUSION_MODE == 'rf':
                log.warning('MEC_FUSION_MODE=rf but no fusion_rf artifact '
                            '(%s); serving attention fusion',
                            Config.FUSION_RF_MODEL_PATH)
        self.replicas = [self] + [self._replica(d) for d in devices[1:]]

    def _make_dnn(self, variables: Dict, device):
        """The speech DNN of the mode: the fused BN-folded kernel (K4)
        in bf16 with the kernels on, else the plain live-BN SpeechDNN."""
        make = (make_speech_dnn if self._speech_kernels
                else make_parity_speech_dnn)
        return make(variables, device)

    def _resolve_host_audio(self) -> bool:
        """MEC_HOST_AUDIO_FEATURES as the JAX engine resolves it
        (engine.py:128-146): bf16 only; on for 1/true/yes/on (with numpy
        features where g++ is absent, as in JAX); 'auto' on only with
        >= 4 CPUs and the C++ featurizer built (the numpy one would cost
        more than the waveform's upload). Logs the wire chosen and why."""
        ha = str(Config.HOST_AUDIO_FEATURES).lower()
        cpus = os.cpu_count() or 1
        if self.compute_dtype != torch.bfloat16:
            on, why = False, 'fp32 parity mode'
        elif ha in ('1', 'true', 'yes', 'on'):
            on = True
            why = (f'MEC_HOST_AUDIO_FEATURES={Config.HOST_AUDIO_FEATURES}, '
                   + ('C++ featurizer' if featurizer.have_native()
                      else 'numpy featurizer: g++ not found'))
        elif ha != 'auto':
            on, why = False, (f'MEC_HOST_AUDIO_FEATURES='
                              f'{Config.HOST_AUDIO_FEATURES}')
        elif cpus < 4:
            on, why = False, f'MEC_HOST_AUDIO_FEATURES=auto, {cpus} CPUs < 4'
        elif not featurizer.have_native():
            on, why = False, ('MEC_HOST_AUDIO_FEATURES=auto, no C++ '
                              'featurizer (g++ not found)')
        else:
            on, why = True, (f'MEC_HOST_AUDIO_FEATURES=auto, {cpus} CPUs '
                             'and the C++ featurizer')
        log.info('speech wire: %s (%s)',
                 'host features (bucket, 56) float32' if on else
                 'waveform', why)
        return on

    def _replica(self, device: torch.device) -> 'EmotionEngine':
        """This engine's models on `device`: the same calibrated trees
        and modules, copied (the speech DNN rebuilt from its tree, as the
        fused kernel's parameters are packed at build)."""
        rep = copy.copy(self)
        rep.device = device
        rep.replicas = [rep]
        rep._graphs = StepGraphs()
        for name in ('image', 'bert', 'fusion', 'lstm', 'forest'):
            setattr(rep, name, _move(getattr(self, name), device))
        if self.text_leg is not None:
            rep.text_leg = self.text_leg.to(device)
        if self.speech is not None:
            rep.speech = dict(self.speech,
                              dnn=self._make_dnn(self.speech['variables'],
                                                 device),
                              scaler=_move(self.speech['scaler'], device))
        return rep

    @classmethod
    def from_models_dir(cls, models_dir: Optional[str] = None, *,
                        compute_dtype: Optional[str] = None,
                        device='cuda', mesh: Any = None
                        ) -> 'EmotionEngine':
        """The engine over a models directory (JAX engine.py:279-513):
        each artifact is the .mecp at the basename of its Config path
        under models_dir (models_dir None: the Config path itself). A
        missing artifact leaves its modality on the fallback; the
        deviations are in the module docstring."""
        def path(p: str) -> str:
            if models_dir is not None:
                return os.path.join(models_dir, os.path.basename(p))
            return p

        from mec_tpu_torch.convert import (hf_bert, keras_h5, sklearn_rf,
                                           torch_pt)
        kw: Dict[str, Any] = {}
        paths: Dict[str, str] = {}
        speech = _load_native_or(path(Config.SPEECH_MODEL_PATH),
                                 keras_h5.convert_speech_h5)
        scaler = None
        if speech is not None:
            scaler_path = path(Config.SPEECH_SCALER_PATH)
            npz = os.path.splitext(scaler_path)[0] + '.npz'
            if os.path.exists(npz):
                with np.load(npz) as z:
                    scaler = (z['mean'], z['scale'])
            elif os.path.exists(scaler_path):
                # the JAX engine reads the .pkl at every load; the port
                # caches it as convert_all does
                scaler = keras_h5.load_sklearn_scaler(scaler_path)
                _save_cache(scaler_path, npz, lambda: np.savez(
                    npz, mean=scaler[0], scale=scaler[1]))
        bert_dir = path(Config.BERT_MODEL_PATH)
        nat = os.path.join(bert_dir, 'bert_model.mecp')
        bert = None
        if os.path.exists(nat):
            bert = store.load_params(nat)
        elif any(os.path.exists(os.path.join(bert_dir, f))
                 for f in ('pytorch_model.bin', 'model.safetensors')):
            # JAX engine.py:309-325: convert and cache, without a meta
            bert = {'variables': hf_bert.convert_bert_dir(bert_dir)}
            _save_cache(bert_dir, nat, lambda: store.save_params(
                nat, bert['variables']))
        if bert is not None:
            cfg = (read_config(bert_dir) if os.path.exists(
                os.path.join(bert_dir, 'config.json')) else {})
            kw.update(bert_variables=bert['variables'],
                      bert_kwargs=model_kwargs_from_config(cfg),
                      bert_vocab=WordPieceTokenizer.from_pretrained_dir(
                          bert_dir),
                      bert_meta=bert.get('meta') or {})
            paths['bert'] = nat
        # the Bi-LSTM is loaded (and converted) as in JAX
        # (engine.py:346-364) and serves with its tokenizer only
        lstm = _load_native_or(path(Config.TEXT_MODEL_PATH),
                               keras_h5.convert_lstm_text_h5)
        tok = path(os.path.splitext(Config.TEXT_MODEL_PATH)[0] + '_tokenizer')
        toks = [tok + e for e in ('.json', '.pkl') if os.path.exists(tok + e)]
        if lstm is not None and toks:
            kw.update(lstm_variables=lstm['variables'],
                      lstm_tokenizer=KerasTokenizer.load(toks[0]))
        image_ref = path(Config.IMAGE_MODEL_PATH.replace('.h5', '.pt'))
        image = _load_native_or(image_ref, torch_pt.convert_image_pt)
        if image is not None:
            kw.update(image_variables=image['variables'],
                      image_meta=image['meta'])
            paths['image'] = store.native_path(image_ref)
        fusion = _load_native_or(
            path(Config.FUSION_MODEL_PATH.replace('.pkl', '.pt')),
            lambda p: (torch_pt.convert_fusion_pt(p),
                       {'config': torch_pt.fusion_config_from_pt(p)}))
        if fusion is not None:
            kw.update(fusion_variables=fusion['variables'],
                      fusion_config=fusion['meta'].get('config', {}))
        if Config.FUSION_MODE == 'rf':
            rf = _load_native_or(path(Config.FUSION_RF_MODEL_PATH),
                                 sklearn_rf.convert_fusion_rf)
            if rf is not None:
                kw.update(forest_arrays=rf['variables']['forest'],
                          forest_meta=rf['meta'])
        return cls(speech['variables'] if speech else None, scaler,
                   artifact_paths=paths, compute_dtype=compute_dtype,
                   device=device, mesh=mesh, **kw)

    @staticmethod
    def _validate_forest(meta: Dict[str, Any]) -> Tuple[int, ...]:
        """Reject an unservable forest artifact at load (JAX
        engine.py:253-277, which then serves the fallback ladder; the
        port raises); returns the fitted classes."""
        if 'depth' not in meta:
            raise ValueError('forest artifact missing the depth meta '
                             '(static trace constant) — re-convert it')
        n_feat = int(meta.get('n_features', 3 * Config.NUM_EMOTIONS))
        if n_feat != 3 * Config.NUM_EMOTIONS:
            raise ValueError(
                f'forest expects {n_feat} features; the fusion input is '
                f'{3 * Config.NUM_EMOTIONS} concatenated softmax outputs')
        classes = tuple(int(c) for c in
                        meta.get('classes', range(Config.NUM_EMOTIONS)))
        if not set(classes) <= set(range(Config.NUM_EMOTIONS)):
            raise ValueError(f'forest classes {classes} are not emotion '
                             f'ids 0..{Config.NUM_EMOTIONS - 1}')
        if len(classes) < Config.NUM_EMOTIONS:
            # trained on data missing some emotions: legal, the outputs
            # scatter into the full vector
            log.warning('forest fusion trained on %d/%d classes; missing '
                        'emotions get probability 0', len(classes),
                        Config.NUM_EMOTIONS)
        return classes

    def _bucket(self, n: int) -> int:
        """The batch bucket for n rows, rounded up to a multiple of the
        replica count so it splits over them (JAX engine.py:515-519)."""
        d = len(self.replicas)
        return -(-_bucket_for(n) // d) * d

    def _to_device(self, arrays) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in arrays)

    def _blocks(self, args) -> List[List]:
        """Each replica's arguments on its device: each argument is a host
        array or a tuple of them (a wire), every one with the bucket's
        rows leading, and replica r takes the r-th contiguous block of
        rows."""
        d = len(self.replicas)
        rows = (args[0][0] if isinstance(args[0], tuple) else args[0]).shape[0]
        per = rows // d

        def block(a, r):
            if isinstance(a, tuple):
                return self.replicas[r]._to_device(
                    x[r * per:(r + 1) * per] for x in a)
            return self.replicas[r]._to_device((a[r * per:(r + 1) * per],))[0]

        return [[block(a, r) for a in args] for r in range(d)]

    def _run(self, step: str, *args) -> np.ndarray:
        """Device step `step` (a method name) over the replicas (_blocks).
        Every block is copied in before any is launched and launched
        before any is fetched (the spans step.h2d, step.launch,
        step.fetch), and the packed outputs come back concatenated in row
        order, as numpy. Where every replica holds a graph of the step at
        its block's shapes and dtypes, the graphs replay (the span
        step.replay); otherwise the step method runs eagerly."""
        with stage_timer.span('step.h2d', step=step):
            ins = self._blocks(args)
        with stage_timer.span('step.launch', step=step):
            graphs = [rep._graphs.get(step, x)
                      for rep, x in zip(self.replicas, ins)]
            if None in graphs:
                outs = [getattr(rep, step)(*x)
                        for rep, x in zip(self.replicas, ins)]
            else:
                with stage_timer.span('step.replay', step=step):
                    outs = [rep._graphs.replay(g, x) for rep, g, x
                            in zip(self.replicas, graphs, ins)]
        with stage_timer.span('step.fetch', step=step):
            return np.concatenate([o.cpu().numpy() for o in outs])

    def _capture(self, step: str, *args) -> None:
        """Capture `step` at these host arguments' shapes (as _run takes
        them) into a CUDA graph on every replica on a card; _run replays
        it from then on. The step must have run eagerly at these shapes
        first. Nothing is captured on the CPU, nor where a graph of these
        shapes is held already."""
        for rep, x in zip(self.replicas, self._blocks(args)):
            if rep.device.type == 'cuda' and rep._graphs.get(step, x) is None:
                rep._graphs.capture(step, getattr(rep, step), x)

    def _drop_graphs(self) -> None:
        """Forget every replica's captured steps: their addresses point at
        the weights and scales being replaced."""
        for rep in self.replicas:
            rep._graphs.clear()

    @property
    def _compress(self) -> bool:
        """The compressed wire formats (12-bit PCM, YUV 4:2:0) ship in
        bf16 serving mode only, as in the JAX engine."""
        return (self.compute_dtype == torch.bfloat16
                and bool(Config.WIRE_COMPRESS))

    @property
    def _all_live(self) -> bool:
        return (self._fusion_kind is not None and self.speech is not None
                and self._text_live and self.image is not None)

    @property
    def _text_live(self) -> bool:
        return self.bert is not None or self.text_leg is not None

    @property
    def text_tokenizer(self) -> Optional[WordPieceTokenizer]:
        """The text leg's WordPiece tokenizer."""
        return (self.text_leg.tokenizer if self.text_leg is not None
                else self.bert_tokenizer)

    @staticmethod
    def _insert_cached_scales(art: Dict, key: str, what: str) -> bool:
        """Static act scales from art['meta']['int8_scales'][key] (the
        JAX package's cache) into art['variables']; False when there is
        no entry or it does not fit the tree (then the caller
        recalibrates, as the JAX engine does)."""
        ent = (art['meta'].get('int8_scales') or {}).get(key)
        if not ent:
            return False
        try:
            art['variables'] = insert_static_scales(
                art['variables'], {k: float(v) for k, v in ent.items()})
        except ValueError as e:
            log.warning('stale %s int8 scale cache (%s); recalibrating',
                        what, e)
            return False
        return True

    # ------------------------------------------------------------------
    # speech
    # ------------------------------------------------------------------
    def _wire_waves(self, waves: np.ndarray, bucket: int):
        """Host side of the wire, row-padded to the bucket (JAX
        engine.py:975-998): with the host audio features on, the
        (bucket, 56) float32 features (waveforms are featurized here;
        rows already 56 wide pass through); else bf16 ships packed
        12-bit PCM + per-clip scale (Config.WIRE_COMPRESS) or PCM16, and
        fp32 parity mode the float32 samples."""
        if self._host_audio:
            if waves.shape[1] != N_FEATURES:
                waves = featurizer.extract56(waves)
            return (_pad_rows(np.ascontiguousarray(waves, np.float32),
                              bucket),)
        if self._compress:
            packed, scale = wire.encode_pcm12(waves)
            return (_pad_rows(packed, bucket), _pad_rows(scale, bucket))
        if self.compute_dtype == torch.bfloat16:
            pcm = np.clip(np.rint(waves * 32768.0),
                          -32768, 32767).astype(np.int16)
            return (_pad_rows(pcm, bucket),)
        return (_pad_rows(np.asarray(waves, np.float32), bucket),)

    @torch.inference_mode()
    def _speech_forward(self, wire_dev: Tuple[torch.Tensor, ...]
                        ) -> torch.Tensor:
        """Device step: wire -> (bucket, 7 + 64) [probs | penult]: the
        host's 56 features with the host audio on, else the frontend at
        self._dft_precision on the decoded waveform; then the DNN of the
        mode (bf16: the fused kernel's packed row; fp32: the live-BN
        module)."""
        if self._host_audio:
            feats = wire_dev[0]
        else:
            if len(wire_dev) == 2:
                waves = wire.decode_pcm12(*wire_dev)
            elif wire_dev[0].dtype == torch.int16:
                waves = wire_dev[0].to(torch.float32) / 32768.0
            else:
                waves = wire_dev[0]
            feats = af.audio_features_56(waves, self._dft_precision)
        mean, scale = self.speech['scaler']
        dnn = self.speech['dnn']
        packed = dnn((feats - mean) / scale)
        return packed[:, :dnn.n_classes + dnn.penult_dim]

    def _run_speech(self, waves: np.ndarray):
        b = self._bucket(waves.shape[0])
        packed = self._run('_speech_forward',
                           self._wire_waves(waves, b))[:waves.shape[0]]
        n_cls = self.speech['dnn'].n_classes
        return packed[:, :n_cls], packed[:, n_cls:]

    def predict_speech_waves(self, waves: np.ndarray,
                             want_features: bool = False) -> List[Dict]:
        """(B, 66150) float32 -> result dicts (+features for fusion)."""
        if self.speech is None:
            return [self._speech_heuristic(w) for w in waves]
        probs, penult = self._run_speech(waves)
        out = []
        for i in range(waves.shape[0]):
            r = result_dict(probs[i])
            if want_features:
                r['_features'] = penult[i]
            out.append(r)
        return out

    def _speech_heuristic(self, wave: np.ndarray) -> Dict[str, Any]:
        """RMS/centroid threshold fallback (reference
        speech_inference.py:36-58), on the host."""
        zcr, centroid, rolloff, rms = af.spectral_features_4(
            torch.from_numpy(np.asarray(wave, np.float32))[None, :])[0]
        if rms > 0.06 and centroid > 2000:
            label = 'angry'
        elif rms < 0.02 and centroid < 1500:
            label = 'sad'
        else:
            label = 'neutral'
        return _fallback(label)

    def predict_speech_paths(self, paths: Sequence[str],
                             want_features: bool = False) -> List[Dict]:
        waves = np.zeros((len(paths), af.N_SAMPLES), np.float32)
        decoded = np.ones(len(paths), bool)
        for i, p in enumerate(paths):
            try:
                waves[i] = wav.load_and_fix_length(p)[0]
            except Exception as e:  # degrade-don't-fail: undecodable ->
                log.warning('audio decode failed for %s: %s', p, e)
                decoded[i] = False
        out = self.predict_speech_waves(waves, want_features)
        for i, ok in enumerate(decoded):
            if not ok:
                out[i] = _fallback('neutral')
        return out

    # ------------------------------------------------------------------
    # text
    # ------------------------------------------------------------------
    def _load_bert(self, variables: Dict, kwargs: Dict, vocab,
                   meta: Dict) -> None:
        """Quantize and calibrate as the JAX engine does at load
        (engine.py:461-474, :645-680, :747-758), raising where it would
        log and serve a weaker mode; then build the model."""
        self._drop_graphs()
        kwargs = {k: v for k, v in kwargs.items() if k in _BERT_FIELDS}
        if isinstance(vocab, WordPieceTokenizer):
            self.bert_tokenizer = vocab
        elif vocab is not None:
            self.bert_tokenizer = WordPieceTokenizer(dict(vocab))
        else:
            log.warning('BERT vocab missing; text model disabled')
            return
        # the C++ encoder for ASCII batches (JAX engine.py:330-338); the
        # Python encoder for the rest and where g++ is absent
        accelerate(self.bert_tokenizer)
        bf16 = self.compute_dtype == torch.bfloat16
        if bf16 and Config.BERT_INT8:
            variables = quantize_bert_params(variables)
            self._bert_quant = True
        self.bert = {'variables': variables, 'kwargs': kwargs, 'meta': meta}
        if self._bert_quant and Config.INT8_STATIC:
            self._calibrate_bert_static()
            self._bert_quant_mode = 'static'
        model = BertForSequenceClassification(
            **kwargs, dtype=self.compute_dtype, gelu_approximate=bf16,
            quant=self._bert_quant, quant_mode=self._bert_quant_mode)
        model.load_state_dict(bert_state_from_jax(self.bert['variables']))
        self.bert['model'] = model.to(self.device).eval().requires_grad_(
            False)

    def _bert_scales_key(self) -> str:
        """The JAX engine's BERT scale-cache key (engine.py:653-655)."""
        gelu = int(self.compute_dtype == torch.bfloat16)
        return (f'bert|seq{Config.MAX_TEXT_LENGTH}|{self._dtype_name}|'
                f'gelu{gelu}|m1.25|v1')

    def _calibrate_bert_static(self) -> None:
        """Static act scales for the quantized BERT tree: from
        meta['int8_scales'][key] when present and complete, else one
        dynamic-mode forward on the device of seven keyworded sentences,
        one per emotion, at MAX_TEXT_LENGTH (engine.py:670-675)."""
        self._drop_graphs()
        key = self._bert_scales_key()
        if self._insert_cached_scales(self.bert, key, 'BERT'):
            self._bert_scales_cached = True
            return
        dyn = BertForSequenceClassification(
            **self.bert['kwargs'], dtype=self.compute_dtype,
            gelu_approximate=self.compute_dtype == torch.bfloat16,
            quant=True, quant_mode='dynamic')
        dyn.load_state_dict(bert_state_from_jax(self.bert['variables']))
        dyn = dyn.to(self.device).eval()
        ids, mask = self.bert_tokenizer.encode_batch(
            [f'i feel so {e} about all of this today' for e in EMOTIONS],
            Config.MAX_TEXT_LENGTH)
        self.bert['variables'] = calibrate_static_scales(
            dyn, self.bert['variables'], self._to_device((ids, mask)))
        self._scales_cache_put(self._bert_native_path, key,
                               extract_static_scales(self.bert['variables']))

    @staticmethod
    def _scales_cache_put(nat_path: Optional[str], key: str,
                          scales: Dict[str, float]) -> None:
        """Write first-calibration act scales into the artifact's .mecp
        meta under the JAX engine's key (engine.py:575-593), so a later
        engine build of either package skips the calibration. A
        read-only directory (OSError) is logged and serving goes on;
        anything else raises."""
        if not nat_path or not os.path.exists(nat_path):
            return
        loaded = store.load_params(nat_path)
        meta = loaded.get('meta') or {}
        cache = dict(meta.get('int8_scales') or {})
        cache[key] = {k: float(v) for k, v in scales.items()}
        try:
            store.save_params(nat_path, loaded['variables'],
                              meta=dict(meta, int8_scales=cache))
        except OSError as e:
            log.warning('int8 scale cache not persisted to %s: %s',
                        nat_path, e)

    @torch.inference_mode()
    def _text_forward(self, ids: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
        """Device step: (bucket, L) ids/mask -> (bucket, 7 + H)
        [probs | CLS] (JAX bert_fwd, engine.py:836-839), or the text
        leg's [probs | feature]."""
        return self._text_outputs(ids, mask)[0]

    def _text_outputs(self, ids: torch.Tensor, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The text leg's packed rows and its step counters (None for
        BERT)."""
        if self.text_leg is not None:
            return self.text_leg.forward(ids, mask)
        logits, cls = self.bert['model'](ids, mask)
        return torch.cat([torch.softmax(logits, dim=-1), cls], dim=-1), None

    def _seq_slice(self, ids: np.ndarray, mask: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Slice BERT inputs to the smallest Config.SEQ_BUCKETS bucket
        covering the batch's longest real sequence. Exact: padded keys'
        additive bias gives them attention weight 0.0, so dropping them
        cannot change any logit."""
        longest = int(mask.sum(axis=1).max()) if mask.size else 1
        for s in sorted(Config.SEQ_BUCKETS):
            if longest <= s and s <= ids.shape[1]:
                return ids[:, :s], mask[:, :s]
        return ids, mask

    def _text_wire(self, texts: Sequence[str], bucket: int):
        ids, mask = self._seq_slice(*self.text_tokenizer.encode_batch(
            list(texts), Config.MAX_TEXT_LENGTH))
        return _pad_rows(ids, bucket), _pad_rows(mask, bucket)

    def text_keyword_heuristic(self, text: str) -> Dict[str, Any]:
        """Keyword-map fallback (reference text_inference.py:53-70)."""
        cleaned = clean_text(text)
        selected = 'neutral'
        for label, keywords in KEYWORD_MAP.items():
            for kw in keywords:
                if f' {kw} ' in f' {cleaned} ':
                    selected = label
                    break
            if selected != 'neutral':
                break
        return _fallback(selected)

    def predict_texts(self, texts: Sequence[str],
                      want_features: bool = False) -> List[Dict]:
        if not self._text_live:
            return [self.text_keyword_heuristic(t) for t in texts]
        b = self._bucket(len(texts))
        packed = self._run('_text_forward',
                           *self._text_wire(texts, b))[:len(texts)]
        n = len(EMOTIONS)
        out = []
        for i in range(len(texts)):
            r = result_dict(packed[i, :n])
            if want_features:
                r['_features'] = packed[i, n:]
            out.append(r)
        return out

    @torch.inference_mode()
    def _lstm_forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Device step: (bucket, MAX_TEXT_LENGTH) ids -> (bucket, 7)
        probabilities (JAX lstm_fwd, engine.py:841-843)."""
        return self.lstm['model'](ids)[0]

    def predict_texts_lstm(self, texts: Sequence[str]) -> List[Dict]:
        """The fast Bi-LSTM variant (JAX engine.py:1117-1128; reference
        text_lstm_inference.py); the keyword map without its artifact."""
        if self.lstm is None or self.lstm_tokenizer is None:
            return [self.text_keyword_heuristic(t) for t in texts]
        cleaned = [t.lower().strip() for t in texts]
        ids = self.lstm_tokenizer.encode_batch(cleaned,
                                               Config.MAX_TEXT_LENGTH)
        b = self._bucket(ids.shape[0])
        probs = self._run('_lstm_forward', _pad_rows(ids, b))[:len(texts)]
        return [result_dict(p) for p in probs]

    # ------------------------------------------------------------------
    # image
    # ------------------------------------------------------------------
    def _load_image(self, variables: Dict, meta: Dict) -> None:
        """Fold, quantize and calibrate as the JAX engine does at load
        (engine.py:433-460, :714-731), raising where it would log and
        serve a weaker mode; then build the model on the device."""
        self._drop_graphs()
        self._image_arch = ('mobilenet_v2' if 'conv_stem' in
                            variables['params'] else 'resnet50')
        size = meta.get('img_size')
        if size:
            self._image_size = ((int(size), int(size)) if np.isscalar(size)
                                else tuple(int(v) for v in size))
        if self.compute_dtype == torch.bfloat16 and Config.FOLD_BN:
            variables = fold_conv_bn(variables)
            self._image_folded = True
        if self._image_folded and Config.IMAGE_INT8:
            variables = quantize_image_params(variables)
            self._image_quant = True
        self.image = {'variables': variables, 'meta': meta,
                      'mean': self._const(IMAGENET_MEAN),
                      'std': self._const(IMAGENET_STD),
                      'u8_max': self._const(255.0)}
        if self._image_quant and Config.INT8_STATIC:
            self._calibrate_image_static()
            self._image_quant_mode = 'static'
        model = _IMAGE_MODELS[self._image_arch](
            dtype=self.compute_dtype, fold_bn=self._image_folded,
            quant=self._image_quant, quant_mode=self._image_quant_mode)
        model.load_state_dict(image_state_from_jax(self.image['variables']))
        self.image['model'] = model.to(self.device).eval().requires_grad_(
            False)

    def _const(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def _calibration_images(self) -> np.ndarray:
        """Deterministic synthetic calibration batch (normalized NHWC),
        the JAX engine's (engine.py:547-569): noise at two contrasts,
        both gradients, and the range extremes."""
        h, w = self._image_size
        rng = np.random.RandomState(0)
        yy = np.broadcast_to(
            np.linspace(0.0, 255.0, h, dtype=np.float32)[:, None, None],
            (h, w, 3))
        xx = np.broadcast_to(
            np.linspace(0.0, 255.0, w, dtype=np.float32)[None, :, None],
            (h, w, 3))
        frames = [rng.randint(0, 256, (h, w, 3)).astype(np.float32),
                  rng.randint(96, 160, (h, w, 3)).astype(np.float32),
                  yy, xx,
                  np.full((h, w, 3), 255.0, np.float32),
                  np.zeros((h, w, 3), np.float32)]
        x = np.stack(frames) / 255.0
        mean = np.asarray(IMAGENET_MEAN, np.float32)
        std = np.asarray(IMAGENET_STD, np.float32)
        return ((x - mean) / std).astype(np.float32)

    def _image_scales_key(self) -> str:
        """The JAX engine's scale-cache key (engine.py:610-615), which
        names the architecture."""
        h, w = self._image_size
        return (f'image|{self._image_arch}|{h}x{w}|{self._dtype_name}|'
                f'm1.25|v1')

    def _calibrate_image_static(self) -> None:
        """Static act scales for the quantized tree: from
        meta['int8_scales'][key] when present and complete, else one
        forward of the calibration batch through the architecture's
        dynamic-mode model on the device, written back into the .mecp
        meta."""
        self._drop_graphs()
        key = self._image_scales_key()
        if self._insert_cached_scales(self.image, key, 'image'):
            self._image_scales_cached = True
            return
        dyn = _IMAGE_MODELS[self._image_arch](
            dtype=self.compute_dtype, fold_bn=True, quant=True,
            quant_mode='dynamic')
        dyn.load_state_dict(image_state_from_jax(self.image['variables']))
        dyn = dyn.to(self.device).eval()
        x = torch.from_numpy(self._calibration_images()).to(self.device)
        self.image['variables'] = calibrate_static_scales(
            dyn, self.image['variables'], x)
        self._scales_cache_put(self._image_native_path, key,
                               extract_static_scales(self.image['variables']))

    def _wire_image(self, imgs: np.ndarray, bucket: int):
        """bf16 with Config.WIRE_COMPRESS ships YUV 4:2:0 (half the
        uint8 RGB bytes; needs even H, W), otherwise raw uint8 RGB.
        Row-padded to the bucket."""
        if self._compress and imgs.shape[1] % 2 == 0 \
                and imgs.shape[2] % 2 == 0:
            y8, uv8 = wire.encode_yuv420(imgs)
            return (_pad_rows(y8, bucket), _pad_rows(uv8, bucket))
        return (_pad_rows(np.ascontiguousarray(imgs, np.uint8), bucket),)

    @torch.inference_mode()
    def _image_forward(self, wire_dev: Tuple[torch.Tensor, ...]
                       ) -> torch.Tensor:
        """Device step: wire -> (bucket, 7 + 512) [probs | feat]
        (JAX image_fwd, engine.py:845-850)."""
        if len(wire_dev) == 2:
            x = wire.decode_yuv420(*wire_dev)
        else:
            x = wire_dev[0].to(torch.float32)
        img = self.image
        x = (x / img['u8_max'] - img['mean']) / img['std']
        logits, feat = img['model'](x)
        return torch.cat([torch.softmax(logits, dim=-1), feat], dim=-1)

    def _run_image(self, imgs: np.ndarray):
        b = self._bucket(imgs.shape[0])
        packed = self._run('_image_forward',
                           self._wire_image(imgs, b))[:imgs.shape[0]]
        return packed[:, :len(EMOTIONS)], packed[:, len(EMOTIONS):]

    def image_fallback(self) -> Dict[str, Any]:
        return _fallback(self.IMAGE_FALLBACK_LABEL)

    def predict_images(self, imgs_u8: np.ndarray,
                       want_features: bool = False) -> List[Dict]:
        """(B, H, W, 3) uint8 -> result dicts (H, W = self._image_size,
        224x224 unless the meta declares another size)."""
        if self.image is None:
            return [self.image_fallback() for _ in range(imgs_u8.shape[0])]
        probs, feat = self._run_image(imgs_u8)
        out = []
        for i in range(imgs_u8.shape[0]):
            r = result_dict(probs[i])
            if want_features:
                r['_features'] = feat[i]
            out.append(r)
        return out

    def _ensure_decode_pool(self):
        if self._decode_pool is None:
            with self._decode_pool_lock:
                if self._decode_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._decode_pool = ThreadPoolExecutor(
                        max_workers=4, thread_name_prefix='mec-decode')
        return self._decode_pool

    def _decode_images(self, paths: Sequence[str]) -> np.ndarray:
        """Decode + resize on a small thread pool (PIL releases the GIL
        in its decode and resize). Raises on the first bad image."""
        size = self._image_size
        if len(paths) <= 1:
            return np.stack([load_image_uint8(p, size) for p in paths])
        return np.stack(list(self._ensure_decode_pool().map(
            lambda p: load_image_uint8(p, size), paths)))

    def predict_image_paths(self, paths: Sequence[str],
                            want_features: bool = False) -> List[Dict]:
        if self.image is None:
            return [self.image_fallback() for _ in paths]
        try:
            imgs = self._decode_images(paths)
        except Exception as e:  # degrade-don't-fail: the whole batch
            log.warning('image decode failed: %s', e)
            return [self.image_fallback() for _ in paths]
        return self.predict_images(imgs, want_features)

    # ------------------------------------------------------------------
    # fusion
    # ------------------------------------------------------------------
    def fuse_weighted(self, speech_probs, text_probs, image_probs
                      ) -> Dict[str, Any]:
        """Weighted-average fallback
        (reference multimodal_fusion.py:184-199)."""
        n = len(EMOTIONS)
        s = np.array(speech_probs) if speech_probs is not None else np.zeros(n)
        t = np.array(text_probs) if text_probs is not None else np.zeros(n)
        i = np.array(image_probs) if image_probs is not None else np.zeros(n)
        weighted = (self.WEIGHTS[0] * s + self.WEIGHTS[1] * t
                    + self.WEIGHTS[2] * i)
        if weighted.sum() > 0:
            weighted = weighted / weighted.sum()
        idx = int(np.argmax(weighted))
        return {'emotion': EMOTIONS[idx],
                'confidence': float(weighted[idx]),
                'all_probabilities': weighted.tolist()}

    @torch.inference_mode()
    def _fusion_forward(self, s_feat, t_feat, i_feat, s_p, t_p, i_p
                        ) -> torch.Tensor:
        """Device step: -> (B, 7 + 3 + 3) [probs | attention w | decision
        w] (JAX fusion_fwd, engine.py:852-856)."""
        logits, aw, dw = self.fusion['model'](s_feat, t_feat, i_feat,
                                              s_p, t_p, i_p)
        return torch.cat([torch.softmax(logits, dim=-1), aw, dw], dim=-1)

    def fuse_attention(self, s_feat, t_feat, i_feat, s_p, t_p, i_p
                       ) -> Dict[str, Any]:
        packed = self._fusion_forward(*self._to_device(
            np.asarray(a, np.float32)[None]
            for a in (s_feat, t_feat, i_feat, s_p, t_p, i_p)))[0]
        packed = packed.cpu().numpy()
        return self._fusion_result(packed[:7], packed[7:10], packed[10:13])

    @staticmethod
    def _fusion_result(probs, aw, dw) -> Dict[str, Any]:
        r = result_dict(probs)
        r['attention_weights'] = {'speech': float(aw[0]),
                                  'text': float(aw[1]),
                                  'image': float(aw[2])}
        r['decision_weights'] = {'speech': float(dw[0]),
                                 'text': float(dw[1]),
                                 'image': float(dw[2])}
        return r

    @torch.inference_mode()
    def _forest_forward(self, s_p, t_p, i_p) -> torch.Tensor:
        """Device step of the rf fusion (JAX forest_fwd,
        engine.py:870-877): the forest's walk over the concatenated
        softmax outputs in fp32 -> (B, 7); a forest fitted on fewer
        classes scatters into the full vector."""
        x = torch.cat([s_p, t_p, i_p], dim=-1).float()
        p = forest_apply(self.forest['arrays'], x, self.forest['depth'])
        if self.forest['classes'] == tuple(range(Config.NUM_EMOTIONS)):
            return p
        full = p.new_zeros((p.shape[0], Config.NUM_EMOTIONS))
        full[:, self.forest['index']] = p
        return full

    def _fusion_from_packed(self, row: np.ndarray) -> Dict[str, Any]:
        """Slice the fusion tail of a packed tri-modal output row."""
        if self._fusion_kind == 'rf':
            r = result_dict(row[21:28])
            r['method'] = 'random_forest'
            return r
        return self._fusion_result(row[21:28], row[28:31], row[31:34])

    # ------------------------------------------------------------------
    # tri-modal (reference multimodal_fusion.py:244-287)
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def _trimodal_forward(self, w_wire: Tuple[torch.Tensor, ...],
                          ids: torch.Tensor, mask: torch.Tensor,
                          i_wire: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """Device step of the tri-modal request (JAX trimodal_fwd,
        engine.py:879-894): the three encoders and the fusion ->
        (bucket, 34) [s 7 | t 7 | i 7 | fusion 7 | attn 3 | decision 3],
        or in rf mode (bucket, 28) [s 7 | t 7 | i 7 | forest 7]; a text
        leg with counters adds them as float32 columns, the same in every
        row (_split_counters)."""
        n = len(EMOTIONS)
        with stage_timer.span('step.launch.speech'):
            s = self._speech_forward(w_wire)
        with stage_timer.span('step.launch.text'):
            t, counts = self._text_outputs(ids, mask)
        with stage_timer.span('step.launch.image'):
            im = self._image_forward(i_wire)
        with stage_timer.span('step.launch.fusion'):
            if self._fusion_kind == 'rf':
                f = self._forest_forward(s[:, :n], t[:, :n], im[:, :n])
            else:
                f = self._fusion_forward(s[:, n:], t[:, n:], im[:, n:],
                                         s[:, :n], t[:, :n], im[:, :n])
            row = torch.cat([s[:, :n], t[:, :n], im[:, :n], f], dim=-1)
            if counts is None:
                return row
            return torch.cat([row.float(), counts.float().expand(
                row.shape[0], -1)], dim=-1)

    def _split_counters(self, packed: np.ndarray) -> np.ndarray:
        """The tri-modal rows without the text leg's counter columns, which
        are recorded on the StageTimer (summed over the replicas' blocks,
        whose rows each carry their block's counts)."""
        cols = _TRIMODAL_COLS[self._fusion_kind]
        if self.text_leg is None or packed.shape[1] == cols:
            return packed
        per = packed.shape[0] // len(self.replicas)
        summed = packed[::per, cols:].sum(axis=0)
        for name, v in self.text_leg.counter_means(summed).items():
            stage_timer.record(name, v)
        return packed[:, :cols]

    def _trimodal_wire(self, waves, texts: Sequence[str], imgs, b: int):
        """The tri-modal step's arguments, row-padded to bucket b, under
        trimodal.wire_encode: the audio wire (.speech), WordPiece, the
        sequence bucket and padding (.text), the image wire (.image).
        waves and imgs are arrays or lists of rows (stacked here)."""
        span = stage_timer.span
        with span('trimodal.wire_encode'):
            with span('trimodal.wire_encode.speech'):
                w_wire = self._wire_waves(np.asarray(waves), b)
            with span('trimodal.wire_encode.text'):
                ids, mask = self._text_wire(texts, b)
            with span('trimodal.wire_encode.image'):
                i_wire = self._wire_image(np.asarray(imgs), b)
        return w_wire, ids, mask, i_wire

    def _run_trimodal(self, waves, texts: Sequence[str], imgs) -> np.ndarray:
        """Host side of one tri-modal dispatch: (n, 66150) waves, n
        texts, (n, H, W, 3) uint8 (arrays or lists of rows) -> the packed
        (n, 34) rows ((n, 28) in rf mode)."""
        n = len(texts)
        args = self._trimodal_wire(waves, texts, imgs, self._bucket(n))
        with stage_timer.span('trimodal.dispatch_fetch'):
            packed = self._run('_trimodal_forward', *args)
        return self._split_counters(packed)[:n]

    def _trimodal_result(self, row: np.ndarray) -> Dict[str, Dict]:
        return {'speech': result_dict(row[:7]),
                'text': result_dict(row[7:14]),
                'image': result_dict(row[14:21]),
                'fusion': self._fusion_from_packed(row)}

    def predict_multimodal(self, audio_path: Optional[str] = None,
                           text: Optional[str] = None,
                           image_path: Optional[str] = None
                           ) -> Dict[str, Dict]:
        if self._all_live and audio_path and text and image_path:
            return self._predict_trimodal_fused(audio_path, text,
                                                image_path)
        results: Dict[str, Dict] = {}
        if audio_path:
            results['speech'] = self.predict_speech_paths([audio_path])[0]
        if text:
            results['text'] = self.predict_texts([text])[0]
        if image_path:
            results['image'] = self.predict_image_paths([image_path])[0]
        if len(results) > 1:
            results['fusion'] = self.fuse_weighted(
                results.get('speech', {}).get('all_probabilities'),
                results.get('text', {}).get('all_probabilities'),
                results.get('image', {}).get('all_probabilities'))
        for r in results.values():
            r.pop('_features', None)
        return results

    def _predict_trimodal_fused(self, audio_path: str, text: str,
                                image_path: str) -> Dict[str, Dict]:
        """One device step for a full tri-modal request. An undecodable
        upload takes the fallback ladder (_predict_degraded: the same
        dicts the JAX engine's per-modality path gives it) and leaves
        _last_b1_phases empty; the device step itself is not guarded.

        It records the batch path's spans (its decode as
        request.decode), and _last_b1_phases (ms; the JAX engine's keys,
        engine.py:1263-1328) is read off them, so that the phases of one
        request sum to its wall: wav_load, tokenize (WordPiece and the
        sequence bucket), image_load, wire_encode (the audio wire, the
        text rows' padding, the image wire), dispatch_fetch (_run: copies
        in, the device step, the packed row back) and result_unpack."""
        self._last_b1_phases = {}
        request = {'text': text, 'image_path': image_path}
        b = self._bucket(1)
        span = stage_timer.span
        img = None
        with span('trimodal.dispatch', rows=1, bucket=b):
            with span('request.decode'):
                with span('request.decode.speech') as wav_span:
                    try:
                        wave = wav.load_and_fix_length(audio_path)[0]
                    except Exception as e:  # degrade-don't-fail
                        log.warning('audio decode failed for %s: %s',
                                    audio_path, e)
                        wave = None
                if wave is not None:
                    with span('request.decode.image') as img_span:
                        try:
                            img = load_image_uint8(image_path,
                                                   self._image_size)
                        except Exception as e:  # degrade-don't-fail
                            log.warning('image decode failed: %s', e)
            if img is None:
                with span('trimodal.result_unpack'):
                    return self._predict_degraded(
                        request, wave=wave, audio_failed=wave is None,
                        image_failed=wave is not None)
            # the batch path's wire spans, opened here so that the clock
            # can split WordPiece (tokenize) from the rest of the wire
            with span('trimodal.wire_encode') as wire_span:
                with span('trimodal.wire_encode.speech'):
                    w_wire = self._wire_waves(wave[None], b)
                with span('trimodal.wire_encode.text') as text_span:
                    ids, mask = self._text_wire([text], b)
                with span('trimodal.wire_encode.image'):
                    i_wire = self._wire_image(img[None], b)
            with span('trimodal.dispatch_fetch') as run_span:
                packed = self._run('_trimodal_forward', w_wire, ids, mask,
                                   i_wire)
            row = self._split_counters(packed)[0]
            with span('trimodal.result_unpack') as unpack_span:
                out = self._trimodal_result(row)
        self._last_b1_phases = {
            'wav_load': wav_span.ms, 'tokenize': text_span.ms,
            'image_load': img_span.ms,
            'wire_encode': wire_span.ms - text_span.ms,
            'dispatch_fetch': run_span.ms, 'result_unpack': unpack_span.ms}
        return out

    def predecode_multimodal(self, request: Dict) -> Dict:
        """Decode a tri-modal request's uploads in the caller's thread
        (the web app's request thread), so batch formation never waits on
        host decode; predict_multimodal_batch consumes the 'wave' /
        'image' arrays directly. A failed decode keeps only the path: the
        batch path re-attempts it and degrades that request."""
        out = dict(request)
        with stage_timer.span('request.decode'):
            if request.get('audio_path') and out.get('wave') is None:
                with stage_timer.span('request.decode.speech'):
                    try:
                        out['wave'] = wav.load_and_fix_length(
                            request['audio_path'])[0]
                    except Exception:
                        pass
            if request.get('image_path') and out.get('image') is None:
                with stage_timer.span('request.decode.image'):
                    try:
                        out['image'] = load_image_uint8(
                            request['image_path'], self._image_size)
                    except Exception:
                        pass
        return out

    def predict_multimodal_batch(self, requests: Sequence[Dict]
                                 ) -> List[Dict[str, Dict]]:
        """Batched tri-modal: requests with all three inputs share one
        device step; the rest take the per-modality path. Requests may
        carry pre-decoded 'wave'/'image' arrays (predecode_multimodal).
        One undecodable upload degrades only its own request. The whole
        call is the span trimodal.dispatch (attrs: rows, bucket)."""
        with stage_timer.span('trimodal.dispatch',
                              rows=len(requests)) as dispatch:
            out: List[Optional[Dict]] = [None] * len(requests)
            degraded: Dict[int, Dict[str, Any]] = {}
            full_idx = [i for i, r in enumerate(requests)
                        if r.get('audio_path') and r.get('text')
                        and r.get('image_path')]
            good = []
            if self._all_live and full_idx:
                def ready(val):
                    f: Future = Future()
                    f.set_result(val)
                    return f

                pool = (self._ensure_decode_pool()
                        if any(requests[i].get('wave') is None
                               or requests[i].get('image') is None
                               for i in full_idx) else None)
                t_dec = time.perf_counter()
                futs = [(i,
                         ready(requests[i]['wave'])
                         if requests[i].get('wave') is not None else
                         pool.submit(lambda p: wav.load_and_fix_length(p)[0],
                                     requests[i]['audio_path']),
                         ready(requests[i]['image'])
                         if requests[i].get('image') is not None else
                         pool.submit(load_image_uint8,
                                     requests[i]['image_path'],
                                     self._image_size))
                        for i in full_idx]
                for i, wf, imf in futs:
                    try:
                        w = wf.result()
                    except Exception as e:  # degrade-don't-fail
                        log.warning('batch audio decode failed (%s): %s',
                                    requests[i]['audio_path'], e)
                        imf.cancel()
                        degraded[i] = {'audio_failed': True}
                        continue
                    try:
                        good.append((i, w, imf.result()))
                    except Exception as e:  # degrade-don't-fail
                        log.warning('batch image decode failed (%s): %s',
                                    requests[i]['image_path'], e)
                        degraded[i] = {'wave': w, 'image_failed': True}
                stage_timer.record('trimodal.decode_stage_ms',
                                   (time.perf_counter() - t_dec) * 1e3)
            packed = ()
            if good:
                dispatch.attrs['bucket'] = self._bucket(len(good))
                packed = self._run_trimodal(
                    [w for _i, w, _im in good],
                    [requests[i]['text'] for i, _w, _im in good],
                    [im for _i, _w, im in good])
            with stage_timer.span('trimodal.result_unpack'):
                for row, (i, _w, _im) in zip(packed, good):
                    out[i] = self._trimodal_result(row)
                for i, r in enumerate(requests):
                    if out[i] is None:
                        if i in degraded:
                            out[i] = self._predict_degraded(r, **degraded[i])
                        else:
                            out[i] = self.predict_multimodal(
                                r.get('audio_path'), r.get('text'),
                                r.get('image_path'))
            return out

    def _predict_degraded(self, request: Dict, wave=None,
                          audio_failed: bool = False,
                          image_failed: bool = False) -> Dict[str, Dict]:
        """Full tri-modal request with one undecodable upload:
        per-modality results + weighted fusion, exactly what the JAX
        engine's single-request ladder produces, computed from what
        already decoded."""
        results: Dict[str, Dict] = {}
        if audio_failed:
            results['speech'] = _fallback('neutral')
        elif wave is not None:
            results['speech'] = self.predict_speech_waves(wave[None])[0]
        results['text'] = self.predict_texts([request['text']])[0]
        results['image'] = (self.image_fallback() if image_failed
                            else self.predict_image_paths(
                                [request['image_path']])[0])
        results['fusion'] = self.fuse_weighted(
            results['speech'].get('all_probabilities'),
            results['text'].get('all_probabilities'),
            results['image'].get('all_probabilities'))
        for r in results.values():
            r.pop('_features', None)
        return results

    def warmup(self, buckets: Sequence[int] = (1,)) -> None:
        """Run every serving shape of each loaded model once before
        traffic: each batch bucket, and for text and the tri-modal step
        each sequence bucket plus the full length (engine.py:921-965).
        Builds the kernels and their constant tables and warms the
        allocator; on a card, then captures the tri-modal step at each of
        its shapes (_capture), so call it before any traffic."""
        seqs = sorted({s for s in Config.SEQ_BUCKETS
                       if s < Config.MAX_TEXT_LENGTH}
                      | {Config.MAX_TEXT_LENGTH})
        for b in buckets:
            b = self._bucket(b)
            waves = np.zeros((b, af.N_SAMPLES), np.float32)
            imgs = np.zeros((b,) + self._image_size + (3,), np.uint8)
            if self.speech is not None:
                self._run_speech(waves)
            if self.image is not None:
                self._run_image(imgs)
            if self.lstm is not None:
                self._run('_lstm_forward',
                          np.zeros((b, Config.MAX_TEXT_LENGTH), np.int32))
            if not self._text_live:
                continue
            w_wire = self._wire_waves(waves, b)
            i_wire = self._wire_image(imgs, b)
            for s in seqs:
                ids, mask = (np.zeros((b, s), np.int32),
                             np.ones((b, s), np.int32))
                self._run('_text_forward', ids, mask)
                if self._all_live:
                    self._run('_trimodal_forward', w_wire, ids, mask, i_wire)
                    self._capture('_trimodal_forward', w_wire, ids, mask,
                                  i_wire)


_engine: Optional[EmotionEngine] = None
_engine_lock = threading.Lock()


def get_engine(models_dir: Optional[str] = None, reload: bool = False, *,
               device='cuda', mesh: Any = None) -> EmotionEngine:
    """The process-wide engine (JAX engine.py:1511-1517), built by
    EmotionEngine.from_models_dir on `device` (over `mesh`; 'auto': every
    visible card of the data axis) at the first call or with
    reload=True; later calls return it whatever they pass."""
    global _engine
    with _engine_lock:
        if _engine is None or reload:
            _engine = EmotionEngine.from_models_dir(models_dir,
                                                    device=device, mesh=mesh)
        return _engine
