"""Multimodal fusion facade — API parity with
reference inference/multimodal_fusion.py.

predict_multimodal(audio_path?, text?, image_path?) returns per-modality
results plus 'fusion' when >=2 modalities are present; attention fusion
(with attention/decision weights in the payload, reference :225-239) when
the fusion model and all three inputs exist, weighted average
[0.3, 0.35, 0.35] otherwise (reference :184-199). Unlike the reference,
the tri-modal case is ONE device dispatch — encoders are not run twice.

The port's copy of mec_tpu/inference/multimodal_fusion.py, over
mec_tpu_torch.serving.engine.get_engine.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from mec_tpu_torch.serving.engine import get_engine


class MultimodalFusion:
    def __init__(self):
        self.engine = get_engine()
        from mec_tpu_torch.config import Config
        self.emotions = Config.EMOTIONS
        self.weights = list(self.engine.WEIGHTS)
        self.fusion_model = self.engine.fusion
        # modality facades for attribute parity with the reference ctor
        from mec_tpu_torch.inference.speech_inference import SpeechInference
        from mec_tpu_torch.inference.text_inference import TextInference
        from mec_tpu_torch.inference.image_inference import ImageInference
        self.speech_inference = SpeechInference()
        self.text_inference = TextInference()
        self.image_inference = ImageInference()

    def fuse_predictions(self, speech_probs, text_probs, image_probs) -> Dict:
        return self.engine.fuse_weighted(speech_probs, text_probs,
                                         image_probs)

    def fuse_with_attention(self, speech_feat, text_feat, image_feat,
                            speech_pred, text_pred, image_pred) -> Dict:
        if self.engine.fusion is None:
            return self.fuse_predictions(speech_pred, text_pred, image_pred)
        try:
            return self.engine.fuse_attention(speech_feat, text_feat,
                                              image_feat, speech_pred,
                                              text_pred, image_pred)
        except Exception:
            return self.fuse_predictions(speech_pred, text_pred, image_pred)

    def predict_multimodal(self, audio_path: Optional[str] = None,
                           text: Optional[str] = None,
                           image_path: Optional[str] = None) -> Dict:
        return self.engine.predict_multimodal(audio_path, text, image_path)

    def predict_multimodal_batch(self, requests: Sequence[Dict]
                                 ) -> List[Dict]:
        """Batched variant (no reference counterpart)."""
        return self.engine.predict_multimodal_batch(requests)
