"""The inference engine: the speech slice of mec_tpu's EmotionEngine.

Same method names as mec_tpu/serving/engine.py, so the web app
(`create_app(engine=...)`) and the micro-batcher drive it unchanged:

  waveforms -> 12-bit PCM wire (host) -> device -> decode_pcm12 ->
  56-dim frontend (K1 mfcc_mean, K2 tuning_select, K3 rolloff_bins) ->
  standardize -> fused speech DNN (K4) -> packed [probs | penult] ->
  result dicts

Batches pad up to Config.BATCH_BUCKETS, as in the JAX engine. The device
is explicit and never auto-detected; on 'cpu' every kernel wrapper runs
its plain PyTorch version, on 'cuda' the hand-written kernels. Nothing
is caught around the kernels: a kernel that fails raises. A missing
speech model (speech_variables=None) serves the heuristic fallback, and
an undecodable upload gets the neutral fallback for that request only,
as the JAX engine does. Text, image and fusion are not ported yet: their
predict methods raise NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mec_tpu_torch.config import Config
from mec_tpu_torch.ops import audio_features as af
from mec_tpu_torch.ops import wav
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


class EmotionEngine:
    """Owns the speech parameters on one device and serves batches."""

    def __init__(self, speech_variables: Optional[Dict] = None,
                 scaler: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 *, device):
        """speech_variables: the JAX package's Flax SpeechDNN tree of
        numpy arrays ({'params', 'batch_stats'}), or None for the
        heuristic fallback. scaler: (mean, scale), each (56,); None is
        the identity. device: 'cpu' or 'cuda[:n]', never guessed."""
        self.device = torch.device(device)
        if self.device.type == 'cuda':
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' but no CUDA device is "
                                   'available')
        elif self.device.type != 'cpu':
            raise ValueError(f'unsupported device {self.device}')
        self.speech: Optional[Dict[str, Any]] = None
        self.bert = self.lstm = self.image = self.fusion = None
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

    def warmup(self, buckets: Sequence[int] = (1,)) -> None:
        """Run every serving bucket once before traffic: builds the
        kernels and their constant tables and warms the allocator."""
        if self.speech is None:
            return
        for b in buckets:
            self._run_speech(np.zeros((self._bucket(b), af.N_SAMPLES),
                                      np.float32))

    # ------------------------------------------------------------------
    # not ported yet
    # ------------------------------------------------------------------
    def predict_texts(self, texts, want_features=False):
        _not_ported('6 (text branch)')

    def predict_texts_lstm(self, texts):
        _not_ported('10 (Bi-LSTM text variant)')

    def predict_images(self, imgs_u8, want_features=False):
        _not_ported('5 (image branch)')

    def predict_image_paths(self, paths, want_features=False):
        _not_ported('5 (image branch)')

    def predict_multimodal(self, audio_path=None, text=None,
                           image_path=None):
        _not_ported('7 (fusion and the fused forward)')

    def predecode_multimodal(self, request):
        _not_ported('7 (fusion and the fused forward)')

    def predict_multimodal_batch(self, requests):
        _not_ported('7 (fusion and the fused forward)')
