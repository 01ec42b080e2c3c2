"""CLIP BPE tokenizer (host-side, pure Python).

A copy of ``cfgpp_tpu/weights/tokenizer.py``, so that the port imports
nothing of the JAX package; ``tests/test_torch_port_copies.py`` holds the
two equal.

Clean-room implementation of the byte-level BPE scheme CLIP uses, loading
``vocab.json`` + ``merges.txt`` from a local tokenizer directory.  Replaces
the HF tokenizers the reference pulls from the hub
(`latent_diffusion.py:65,101-112`, `latent_sdxl.py:46-47,78-84`).

Padding semantics match the reference calls: pad to ``model_max_length=77``
with the pad token, truncate, wrap in BOS/EOS.

When no vocab files exist (runs with random-init weights have none),
`HashTokenizer` provides a deterministic stand-in so
every pipeline stage — including prompt handling — still runs end-to-end
with random-init models.
"""

from __future__ import annotations

import functools
import json
import os
import re
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

MODEL_MAX_LENGTH = 77
BOS_ID = 49406
EOS_ID = 49407


@functools.lru_cache()
def _bytes_to_unicode():
    """Reversible byte -> printable-unicode map (standard byte-level BPE)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# CLIP's exact pre-tokenizer (openai/CLIP simple_tokenizer): the \p{L} /
# \p{N} classes need the third-party `regex` module (a transformers
# dependency, present wherever HF is).  The `re` fallback approximates:
# letters = [^\W\d_], numbers = \d, and the punctuation run must INCLUDE
# '_' (not a letter/number to CLIP but IS \w — 'snow_leopard' must split
# snow / _ / leopard); it only diverges on non-ASCII numerals like '²'.
try:
    import regex as _regex
    _WORD_PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:
    _WORD_PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
        re.IGNORECASE,
    )


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE with ``</w>`` end-of-word markers (CLIP flavour)."""

    def __init__(self, vocab_path: str, merges_path: str,
                 pad_token_id: Optional[int] = None,
                 model_max_length: int = MODEL_MAX_LENGTH):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        with open(merges_path) as f:
            lines = f.read().split("\n")
        # first line of merges.txt is a version header
        merges = [tuple(l.split()) for l in lines[1:] if l and not l.startswith("#")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_id = self.encoder.get("<|startoftext|>", BOS_ID)
        self.eos_id = self.encoder.get("<|endoftext|>", EOS_ID)
        # SD's tokenizer_1 pads with EOS; SDXL's tokenizer_2 pads with "!".
        self.pad_id = self.eos_id if pad_token_id is None else pad_token_id
        self.model_max_length = model_max_length
        self._cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(text).lower()
        ids: List[int] = []
        for tok in _WORD_PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok) if t in self.encoder)
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize + truncate + BOS/EOS + pad to [B, 77] int32."""
        n = self.model_max_length
        out = np.full((len(texts), n), self.pad_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[: n - 2]
            row = [self.bos_id] + ids + [self.eos_id]
            out[i, : len(row)] = row
        return out


class HashTokenizer:
    """Deterministic fallback tokenizer for environments without vocab files.

    Maps each word to a stable id in [2, vocab_size-2); BOS/EOS/pad follow
    CLIP conventions.  NOT language-meaningful — only for random-weight runs
    and tests.
    """

    def __init__(self, vocab_size: int = 49408, eos_token_id: int = EOS_ID,
                 model_max_length: int = MODEL_MAX_LENGTH,
                 pad_token_id: "Optional[int]" = None):
        self.vocab_size = vocab_size
        self.bos_id = eos_token_id - 1
        self.eos_id = eos_token_id
        # SDXL's tokenizer_2 pads with id 0 ('!'), not EOS — the fallback
        # must mirror that or pad-sensitive paths (masking, pooled-output
        # position) behave differently from real-tokenizer environments
        self.pad_id = eos_token_id if pad_token_id is None else pad_token_id
        self.model_max_length = model_max_length

    def encode(self, text: str) -> List[int]:
        import hashlib
        words = _whitespace_clean(text).lower().split()
        span = max(self.vocab_size - 4, 1)
        return [2 + int(hashlib.md5(w.encode()).hexdigest(), 16) % span for w in words]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        n = self.model_max_length
        out = np.full((len(texts), n), self.pad_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)[: n - 2]
            row = [self.bos_id] + ids + [self.eos_id]
            out[i, : len(row)] = row
        return out


def load_tokenizer(tokenizer_dir: Optional[str] = None, vocab_size: int = 49408,
                   eos_token_id: int = EOS_ID, pad_token_id: Optional[int] = None):
    """Load a real CLIP tokenizer if vocab files are available, else fallback.

    Search order: explicit ``tokenizer_dir`` -> $CFGPP_TOKENIZER_DIR.
    """
    cand = tokenizer_dir or os.environ.get("CFGPP_TOKENIZER_DIR")
    if cand:
        p = Path(cand)
        vocab, merges = p / "vocab.json", p / "merges.txt"
        if vocab.exists() and merges.exists():
            return CLIPTokenizer(str(vocab), str(merges), pad_token_id=pad_token_id)
    return HashTokenizer(vocab_size=vocab_size, eos_token_id=eos_token_id,
                         pad_token_id=pad_token_id)
