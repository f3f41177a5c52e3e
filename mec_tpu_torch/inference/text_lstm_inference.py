"""Fast Bi-LSTM text inference facade + CLI — API parity with
reference inference/text_lstm_inference.py (FastTextEmotionPredictor with
predict / predict_batch and a demo CLI; standalone, not wired into the web
app, reference :134-204).

The port's copy of mec_tpu/inference/text_lstm_inference.py, over
mec_tpu_torch.serving.engine.get_engine.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence

from mec_tpu_torch.serving.engine import get_engine


class FastTextEmotionPredictor:
    def __init__(self):
        self.engine = get_engine()
        from mec_tpu_torch.config import Config
        self.emotions = Config.EMOTIONS
        self.model = self.engine.lstm
        self.tokenizer = self.engine.lstm_tokenizer

    def predict(self, text: str) -> Dict:
        """-> {emotion, confidence, all_probabilities, inference_time_ms}."""
        t0 = time.perf_counter()
        r = dict(self.engine.predict_texts_lstm([text])[0])
        r.pop('_fallback', None)
        r['inference_time_ms'] = (time.perf_counter() - t0) * 1e3
        return r

    def predict_batch(self, texts: Sequence[str]) -> List[Dict]:
        t0 = time.perf_counter()
        results = self.engine.predict_texts_lstm(list(texts))
        dt = (time.perf_counter() - t0) * 1e3
        out = []
        for r in results:
            r = dict(r)
            r.pop('_fallback', None)
            r['inference_time_ms'] = dt / max(len(texts), 1)
            out.append(r)
        return out


def main():
    import argparse
    p = argparse.ArgumentParser(description='Fast Bi-LSTM text emotion CLI')
    p.add_argument('--text', help='single text to classify')
    p.add_argument('--demo', action='store_true',
                   help='run the batch demo sentences')
    args = p.parse_args()
    pred = FastTextEmotionPredictor()
    if args.text:
        r = pred.predict(args.text)
        print(f"{r['emotion']} ({r['confidence']:.3f}) "
              f"in {r['inference_time_ms']:.1f} ms")
        return
    demo = ["I am so happy today!", "This makes me really angry",
            "I feel sad and alone", "What a wonderful surprise!",
            "That is disgusting", "I am terrified of spiders",
            "The weather is okay"]
    for r, t in zip(pred.predict_batch(demo), demo):
        print(f"{r['emotion']:>9s} ({r['confidence']:.3f})  {t}")


if __name__ == '__main__':
    main()
