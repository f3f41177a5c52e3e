"""The inference engine: the speech and image slices of mec_tpu's
EmotionEngine.

Same method names as mec_tpu/serving/engine.py, so the web app
(`create_app(engine=...)`) and the micro-batcher drive it unchanged:

  speech: waveforms -> 12-bit PCM wire (host) -> device -> decode_pcm12
    -> 56-dim frontend (K1 mfcc_mean, K2 tuning_select, K3 rolloff_bins)
    -> standardize -> fused speech DNN (K4) -> packed [probs | penult]
  image: uint8 RGB -> YUV 4:2:0 wire (bf16) or raw uint8 (fp32) ->
    device -> decode + ImageNet normalize -> ResNet50 (bf16: BN folded,
    stem pool K6, int8 bottleneck convs with static scales, layer1 K7;
    fp32: live BN, fp32 convs, plain pool) -> packed [probs | feat]
  -> result dicts

Batches pad up to Config.BATCH_BUCKETS, as in the JAX engine. The device
is explicit and never auto-detected; on 'cpu' every kernel wrapper runs
its plain PyTorch version, on 'cuda' the hand-written kernels. Nothing
is caught around the kernels: a kernel that fails raises. The image
mode follows compute_dtype as in the JAX engine, but where that engine
logs and serves a weaker mode when the BN fold, the int8 quantization
or the static calibration fails, this one raises. The speech path does
not depend on compute_dtype: it serves the 12-bit wire and the
kernels' fp32 numerics in both modes. A missing model serves the
reference's fallbacks (speech: the heuristic ladder; image: neutral),
and an undecodable upload gets the neutral fallback (speech: that
request; image: the whole batch), as the JAX engine does. Text,
fusion and the MobileNetV2 image variant are not ported yet: they raise
NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.convert.from_jax import image_state_from_jax
from mec_tpu_torch.image.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                            load_image_uint8)
from mec_tpu_torch.models.resnet import ImageEmotionModel
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import wav
from mec_tpu_torch.ops.fold import fold_conv_bn
from mec_tpu_torch.ops.quant import (calibrate_static_scales,
                                     insert_static_scales,
                                     quantize_image_params)
from mec_tpu_torch.ops.speech_kernels import make_speech_dnn
from mec_tpu_torch.serving import wire

log = logging.getLogger('mec_tpu_torch.serving')

EMOTIONS = Config.EMOTIONS
N_FEATURES = 56


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


def _not_ported(item: str):
    raise NotImplementedError(
        f'not ported to mec_tpu_torch yet: ROADMAP.md queue A item {item}')


_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class EmotionEngine:
    """Owns the speech and image parameters on one device and serves
    batches."""

    def __init__(self, speech_variables: Optional[Dict] = None,
                 scaler: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 *, image_variables: Optional[Dict] = None,
                 image_meta: Optional[Dict] = None,
                 compute_dtype: Optional[str] = None, device):
        """speech_variables: the JAX package's Flax SpeechDNN tree of
        numpy arrays ({'params', 'batch_stats'}), or None for the
        heuristic fallback. scaler: (mean, scale), each (56,); None is
        the identity. image_variables: the Flax ResNet50 tree
        ({'params', 'batch_stats'}), or None for the neutral fallback;
        image_meta: the artifact's meta ('img_size', and 'int8_scales',
        the JAX package's static-scale cache, honoured by key).
        compute_dtype: 'bfloat16' (serving mode) or 'float32' (parity
        mode); None reads Config.COMPUTE_DTYPE. device: 'cpu' or
        'cuda[:n]', never guessed."""
        self.device = torch.device(device)
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
        self.speech: Optional[Dict[str, Any]] = None
        self.image: Optional[Dict[str, Any]] = None
        self.bert = self.lstm = self.fusion = None
        self._decode_pool = None
        self._decode_pool_lock = threading.Lock()
        if speech_variables is not None:
            if scaler is None:
                scaler = (np.zeros(N_FEATURES, np.float32),
                          np.ones(N_FEATURES, np.float32))
            mean, scale = (torch.from_numpy(np.asarray(a, np.float32)
                                            .reshape(N_FEATURES))
                           .to(self.device) for a in scaler)
            self.speech = {'dnn': make_speech_dnn(speech_variables,
                                                  self.device),
                           'scaler': (mean, scale)}
        self._image_size = tuple(Config.IMAGE_SIZE)
        self._image_folded = self._image_quant = False
        self._image_quant_mode = 'dynamic'
        self._image_scales_cached = False
        if image_variables is not None:
            self._load_image(image_variables, dict(image_meta or {}))

    def _bucket(self, n: int) -> int:
        return _bucket_for(n)

    # ------------------------------------------------------------------
    # speech
    # ------------------------------------------------------------------
    def _wire_waves(self, waves: np.ndarray, bucket: int):
        """Host side of the wire, row-padded to the bucket: packed 12-bit
        PCM + per-clip scale (Config.WIRE_COMPRESS), else PCM16."""
        if Config.WIRE_COMPRESS:
            packed, scale = wire.encode_pcm12_np(waves)
            return (_pad_rows(packed, bucket), _pad_rows(scale, bucket))
        pcm = np.clip(np.rint(waves * 32768.0),
                      -32768, 32767).astype(np.int16)
        return (_pad_rows(pcm, bucket),)

    def _to_device(self, wire_arrays) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in wire_arrays)

    def _speech_forward(self, wire_dev: Tuple[torch.Tensor, ...]
                        ) -> torch.Tensor:
        """Device step: wire -> (bucket, 7 + 64) [probs | penult]."""
        if len(wire_dev) == 2:
            waves = wire.decode_pcm12(*wire_dev)
        else:
            waves = wire_dev[0].to(torch.float32) / 32768.0
        feats = af.audio_features_56(waves)
        mean, scale = self.speech['scaler']
        dnn = self.speech['dnn']
        packed = dnn((feats - mean) / scale)
        return packed[:, :dnn.n_classes + dnn.penult_dim]

    def _run_speech(self, waves: np.ndarray):
        b = self._bucket(waves.shape[0])
        out = self._speech_forward(self._to_device(self._wire_waves(waves, b)))
        packed = out[:waves.shape[0]].cpu().numpy()
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
        probs = heuristic_probs(label)
        return {'emotion': label, 'confidence': float(max(probs)),
                'all_probabilities': probs, '_fallback': True}

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
                probs = heuristic_probs('neutral')
                out[i] = {'emotion': 'neutral',
                          'confidence': float(max(probs)),
                          'all_probabilities': probs, '_fallback': True}
        return out

    # ------------------------------------------------------------------
    # image
    # ------------------------------------------------------------------
    def _load_image(self, variables: Dict, meta: Dict) -> None:
        """Fold, quantize and calibrate as the JAX engine does at load
        (engine.py:433-460, :714-731), raising where it would log and
        serve a weaker mode; then build the model on the device."""
        if 'conv_stem' in variables['params']:
            _not_ported('5 (the MobileNetV2 image variant)')
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
        model = ImageEmotionModel(
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
        """The JAX engine's scale-cache key (engine.py:614-615)."""
        h, w = self._image_size
        dtype = 'bfloat16' if self.compute_dtype == torch.bfloat16 \
            else 'float32'
        return f'image|resnet50|{h}x{w}|{dtype}|m1.25|v1'

    def _cached_scales(self, key: str) -> Optional[Dict[str, float]]:
        ent = (self.image['meta'].get('int8_scales') or {}).get(key)
        if ent:
            return {k: float(v) for k, v in ent.items()}
        return None

    def _calibrate_image_static(self) -> None:
        """Static act scales for the quantized tree: from
        meta['int8_scales'][key] when present and complete, else one
        dynamic-mode forward of the calibration batch on the device. The
        JAX engine also persists new scales into the .mecp meta; the
        port reads no .mecp (ROADMAP A14), so it does not."""
        cached = self._cached_scales(self._image_scales_key())
        if cached is not None:
            try:
                self.image['variables'] = insert_static_scales(
                    self.image['variables'], cached)
                self._image_scales_cached = True
                return
            except ValueError as e:
                log.warning('stale image int8 scale cache (%s); '
                            'recalibrating', e)
        dyn = ImageEmotionModel(dtype=self.compute_dtype, fold_bn=True,
                                quant=True, quant_mode='dynamic')
        dyn.load_state_dict(image_state_from_jax(self.image['variables']))
        dyn = dyn.to(self.device).eval()
        x = torch.from_numpy(self._calibration_images()).to(self.device)
        self.image['variables'] = calibrate_static_scales(
            dyn, self.image['variables'], x)

    def _wire_image(self, imgs: np.ndarray, bucket: int):
        """bf16 with Config.WIRE_COMPRESS ships YUV 4:2:0 (half the
        uint8 RGB bytes; needs even H, W), otherwise raw uint8 RGB.
        Row-padded to the bucket."""
        if (self.compute_dtype == torch.bfloat16 and Config.WIRE_COMPRESS
                and imgs.shape[1] % 2 == 0 and imgs.shape[2] % 2 == 0):
            y8, uv8 = wire.encode_yuv420_np(imgs)
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
        out = self._image_forward(self._to_device(self._wire_image(imgs, b)))
        packed = out[:imgs.shape[0]].cpu().numpy()
        return packed[:, :len(EMOTIONS)], packed[:, len(EMOTIONS):]

    IMAGE_FALLBACK_LABEL = 'neutral'

    def image_fallback(self) -> Dict[str, Any]:
        probs = heuristic_probs(self.IMAGE_FALLBACK_LABEL)
        return {'emotion': self.IMAGE_FALLBACK_LABEL,
                'confidence': float(max(probs)),
                'all_probabilities': probs, '_fallback': True}

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

    def _decode_images(self, paths: Sequence[str]) -> np.ndarray:
        """Decode + resize on a small thread pool (PIL releases the GIL
        in its decode and resize). Raises on the first bad image."""
        size = self._image_size
        if len(paths) <= 1:
            return np.stack([load_image_uint8(p, size) for p in paths])
        if self._decode_pool is None:
            with self._decode_pool_lock:
                if self._decode_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._decode_pool = ThreadPoolExecutor(
                        max_workers=4, thread_name_prefix='mec-decode')
        return np.stack(list(self._decode_pool.map(
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

    def warmup(self, buckets: Sequence[int] = (1,)) -> None:
        """Run every serving bucket of each loaded model once before
        traffic: builds the kernels and their constant tables and warms
        the allocator."""
        for b in buckets:
            b = self._bucket(b)
            if self.speech is not None:
                self._run_speech(np.zeros((b, af.N_SAMPLES), np.float32))
            if self.image is not None:
                self._run_image(np.zeros((b,) + self._image_size + (3,),
                                         np.uint8))

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------
    def predict_texts(self, texts, want_features=False):
        _not_ported('6 (text branch)')

    def predict_texts_lstm(self, texts):
        _not_ported('10 (Bi-LSTM text variant)')

    def predict_multimodal(self, audio_path=None, text=None,
                           image_path=None):
        _not_ported('7 (fusion and the fused forward)')

    def predecode_multimodal(self, request):
        _not_ported('7 (fusion and the fused forward)')

    def predict_multimodal_batch(self, requests):
        _not_ported('7 (fusion and the fused forward)')
