"""Reference-compatible inference facades over the port's engine.

Copies of mec_tpu/inference/ (SpeechInference.predict(path),
TextInference.predict(text), ImageInference.predict(path),
MultimodalFusion.predict_multimodal(a, t, i), FastTextEmotionPredictor),
each a thin view over serving/engine.get_engine(): the process-wide
engine, built from the models directory on the card (device='cuda')
unless a caller built it first with another device. Constructing a
facade per request costs nothing. tests/test_torch_models_dir.py pins
each copy to its original.
"""

from mec_tpu_torch.inference.speech_inference import SpeechInference  # noqa: F401
from mec_tpu_torch.inference.text_inference import TextInference, KEYWORD_MAP  # noqa: F401
from mec_tpu_torch.inference.image_inference import ImageInference  # noqa: F401
from mec_tpu_torch.inference.multimodal_fusion import MultimodalFusion  # noqa: F401
from mec_tpu_torch.inference.text_lstm_inference import FastTextEmotionPredictor  # noqa: F401
