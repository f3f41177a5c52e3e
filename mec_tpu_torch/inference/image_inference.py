"""Image inference facade — API parity with
reference inference/image_inference.py, including the neutral-0.9 fallback
(reference :94-102) and extract_features returning the 512-dim head feature
+ probabilities (reference :131-146) from one forward pass (the reference
runs the ResNet twice).

The port's copy of mec_tpu/inference/image_inference.py, over
mec_tpu_torch.serving.engine.get_engine.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from mec_tpu_torch.serving.engine import get_engine


class ImageInference:
    def __init__(self):
        self.engine = get_engine()
        from mec_tpu_torch.config import Config
        self.emotions = Config.EMOTIONS
        self.model = self.engine.image

    def predict(self, image_file_path: str) -> Dict:
        r = dict(self.engine.predict_image_paths([image_file_path])[0])
        r.pop('_features', None)
        r.pop('_fallback', None)
        return r

    def predict_batch(self, image_file_paths: Sequence[str]) -> List[Dict]:
        out = []
        for r in self.engine.predict_image_paths(list(image_file_paths)):
            r = dict(r)
            r.pop('_features', None)
            r.pop('_fallback', None)
            out.append(r)
        return out

    def extract_features(self, image_file_path: str):
        if self.engine.image is None:
            return None, None
        r = self.engine.predict_image_paths([image_file_path],
                                            want_features=True)[0]
        import numpy as np
        return (np.asarray(r['_features']),
                np.asarray(r['all_probabilities'], dtype=np.float32))
