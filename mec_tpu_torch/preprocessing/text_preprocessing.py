"""Text preprocessing: the port of mec_tpu/preprocessing/
text_preprocessing.py, the public API of
reference preprocessing/text_preprocessing.py, over the port's
WordPiece tokenizer (text/wordpiece.py) and text/cleaning.py, in place
of HF transformers.
"""

from __future__ import annotations

from typing import Optional

from mec_tpu_torch.config import Config
from mec_tpu_torch.text.cleaning import clean_text as _clean_text
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer


class TextPreprocessor:
    """clean_text + BERT tokenization (reference text_preprocessing.py:16-49).

    The tokenizer vocab is loaded from the BERT model directory; when no
    trained model exists, tokenize_bert returns None and callers fall back
    to the keyword heuristic, matching reference behavior with transformers
    absent.
    """

    def __init__(self, model_type: str = 'bert',
                 max_length: int = Config.MAX_TEXT_LENGTH,
                 model_dir: Optional[str] = None):
        self.model_type = model_type
        self.max_length = max_length
        self.tokenizer: Optional[WordPieceTokenizer] = None
        if model_type == 'bert':
            try:
                self.tokenizer = WordPieceTokenizer.from_pretrained_dir(
                    model_dir or Config.BERT_MODEL_PATH)
            except Exception:
                self.tokenizer = None

    def clean_text(self, text: str) -> str:
        return _clean_text(text)

    def tokenize_bert(self, text: str):
        """-> {'input_ids': (1, L) int32, 'attention_mask': (1, L) int32}.

        The reference cleans before tokenizing
        (reference text_preprocessing.py:35-46).
        """
        if not self.tokenizer:
            return None
        text = self.clean_text(text)
        ids, mask = self.tokenizer.encode(text, self.max_length)
        return {'input_ids': ids[None, :], 'attention_mask': mask[None, :]}

    def preprocess_text(self, text: str):
        return self.tokenize_bert(text)
