"""Text cleaning with reference semantics (reference
preprocessing/text_preprocessing.py:28-33): a copy of
mec_tpu/text/cleaning.py, pinned to it by tests/test_torch_text.py."""

import re

_URL_RE = re.compile(r'http\S+|www\S+|https\S+')
_NON_ALPHA_RE = re.compile(r'[^a-zA-Z\s]')


def clean_text(text: str) -> str:
    """lowercase, strip URLs, strip non-alphabetic chars, trim."""
    text = text.lower()
    text = _URL_RE.sub('', text)
    text = _NON_ALPHA_RE.sub('', text)
    return text.strip()
