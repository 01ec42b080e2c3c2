"""The one traffic generator: requests drawn from ``--seed`` and the mix's
parameters (``mixes/<traffic>.json``).

A prompt is ``prompt_words`` = [least, most] words, each 3 to 9 random
lowercase letters; every prompt is padded to the text encoders' 77 tokens, so
its length does not change the work.  A request of ``sample`` is (prompt,
seed); a batch of ``sample_batch`` is ``batch`` prompts under one seed of
the run, with global sample indices counting up from 0.  The same seed
gives the same stream; the work of every unit is the same whatever the
seed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


@dataclasses.dataclass
class Unit:
    """One call of the entry point: a request (one prompt, ``indices``
    None) or a batch (``indices`` the global sample indices)."""
    number: int
    prompts: List[str]
    seed: int
    indices: List[int] = None


class Traffic:
    def __init__(self, mix: Dict, seed: int):
        self.mix = mix
        self.rng = np.random.default_rng([seed % 2 ** 64, 1])
        self.batch_seed = int(self.rng.integers(0, 2 ** 62))
        self.count = 0

    def _prompt(self) -> str:
        lo, hi = self.mix["prompt_words"]
        words = []
        for _ in range(int(self.rng.integers(lo, hi + 1))):
            n = int(self.rng.integers(3, 10))
            words.append("".join(self.rng.choice(LETTERS, n)))
        return " ".join(words)

    def next(self) -> Unit:
        k, self.count = self.count, self.count + 1
        if self.mix["entry"] == "sample":
            return Unit(k, [self._prompt()], int(self.rng.integers(0, 2 ** 62)))
        b = self.mix["batch"]
        return Unit(k, [self._prompt() for _ in range(b)], self.batch_seed,
                    list(range(k * b, (k + 1) * b)))
