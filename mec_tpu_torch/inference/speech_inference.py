"""Speech inference facade — API parity with
reference inference/speech_inference.py.

predict(path) returns {emotion, confidence, all_probabilities}; when no
trained model is available it degrades to the RMS/centroid heuristic with
the 0.9/0.1-split probability vector (reference :36-58). extract_features
returns the 64-dim penultimate activation + probabilities (reference
:79-105) — here from the same single forward pass instead of rebuilding a
truncated Keras model per call.

The port's copy of mec_tpu/inference/speech_inference.py, over
mec_tpu_torch.serving.engine.get_engine.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from mec_tpu_torch.serving.engine import get_engine


class SpeechInference:
    def __init__(self):
        self.engine = get_engine()
        from mec_tpu_torch.config import Config
        self.emotions = Config.EMOTIONS
        self.model = self.engine.speech  # truthy iff a trained model loaded

    def predict(self, audio_file_path: str) -> Dict:
        r = dict(self.engine.predict_speech_paths([audio_file_path])[0])
        r.pop('_features', None)
        r.pop('_fallback', None)
        return r

    def predict_batch(self, audio_file_paths: Sequence[str]) -> List[Dict]:
        """Batched variant (no reference counterpart): one device dispatch."""
        out = []
        for r in self.engine.predict_speech_paths(list(audio_file_paths)):
            r = dict(r)
            r.pop('_features', None)
            r.pop('_fallback', None)
            out.append(r)
        return out

    def extract_features(self, audio_file_path: str):
        """-> (64-dim penultimate vector, probability vector) or (None, None)."""
        if self.engine.speech is None:
            return None, None
        r = self.engine.predict_speech_paths([audio_file_path],
                                             want_features=True)[0]
        import numpy as np
        return (np.asarray(r['_features']),
                np.asarray(r['all_probabilities'], dtype=np.float32))
