"""Text (BERT) inference facade — API parity with
reference inference/text_inference.py, including the keyword-heuristic
fallback (reference :12-20,53-70) and extract_features returning the
768-dim [CLS] embedding + probabilities (reference :106-130) from one
forward pass (the reference runs BERT twice).

The port's copy of mec_tpu/inference/text_inference.py, over
mec_tpu_torch.serving.engine.get_engine.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from mec_tpu_torch.serving.engine import KEYWORD_MAP, get_engine  # noqa: F401

__all__ = ['TextInference', 'KEYWORD_MAP']


class TextInference:
    def __init__(self):
        self.engine = get_engine()
        from mec_tpu_torch.config import Config
        self.emotions = Config.EMOTIONS
        self.model = self.engine.bert
        self.tokenizer = self.engine.bert_tokenizer

    def predict(self, text: str) -> Dict:
        r = dict(self.engine.predict_texts([text])[0])
        r.pop('_features', None)
        r.pop('_fallback', None)
        return r

    def predict_batch(self, texts: Sequence[str]) -> List[Dict]:
        out = []
        for r in self.engine.predict_texts(list(texts)):
            r = dict(r)
            r.pop('_features', None)
            r.pop('_fallback', None)
            out.append(r)
        return out

    def extract_features(self, text: str):
        if self.engine.bert is None:
            return None, None
        r = self.engine.predict_texts([text], want_features=True)[0]
        import numpy as np
        return (np.asarray(r['_features']),
                np.asarray(r['all_probabilities'], dtype=np.float32))
