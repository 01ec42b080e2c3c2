"""A stand-in for T5's SentencePiece tokenizer (SD3's third text encoder),
for runs without its vocabulary (not in the repository): each lower-cased
word maps to a stable id among the SentencePiece pieces, ids
[3, vocab_size - 128) (T5 v1.1's 32128 ids are 32000 pieces, 100
sentinels and 28 of padding).  As T5's tokenizer under SD3's pipeline: no
BOS, EOS (1) after the text, truncated to ``max_length`` with the EOS
kept, padded with 0.  NOT language-meaningful: only for random-weight
runs and tests.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

PAD_ID = 0
EOS_ID = 1
FIRST_PIECE = 3


class T5HashTokenizer:
    def __init__(self, vocab_size: int = 32128, max_length: int = 256):
        self.vocab_size = vocab_size
        self.model_max_length = max_length
        self.pad_id, self.eos_id = PAD_ID, EOS_ID

    def encode(self, text: str):
        span = max(self.vocab_size - 128 - FIRST_PIECE, 1)
        return [FIRST_PIECE + int(hashlib.md5(w.encode()).hexdigest(), 16)
                % span for w in text.lower().split()]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        n = self.model_max_length
        out = np.full((len(texts), n), self.pad_id, dtype=np.int32)
        for i, text in enumerate(texts):
            row = self.encode(text)[: n - 1] + [self.eos_id]
            out[i, : len(row)] = row
        return out
