"""The one traffic generator: texts from a mix's parameters and a seed.

A mix (traffic/<name>.json) names its entry point (`kind`: "generate",
one text per call, or "serve", batches of `batch` texts) and the sizes of
its texts: sentences per text, words per sentence and letters per word,
each a [low, high] range. Sizes are dealt from shuffled decks that hold
every value of the range once, so every seed sends the same sizes in
another order and only the letters differ; letters are drawn from the
configuration's IPA letters that word tokenization keeps whole.
Sentences end in '.', so a text of several is chunked by the engine.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np


def alphabet(symbol: Mapping[str, str]) -> List[str]:
    """The IPA symbols that are letters (a word of them is one token run)."""
    return [c for c in symbol["letters_ipa"] if c.isalpha()]


class _Deck:
    """Values lo..hi, each once per shuffled round."""

    def __init__(self, lo: int, hi: int, rng: np.random.Generator):
        self.values = np.arange(lo, hi + 1)
        self.rng = rng
        self.left: List[int] = []

    def draw(self) -> int:
        if not self.left:
            self.left = list(self.rng.permutation(self.values))
        return int(self.left.pop())


class Texts:
    """An endless stream of texts of one mix."""

    def __init__(self, mix: Mapping, letters: Sequence[str], seed: int):
        self.rng = np.random.default_rng(seed)
        self.letters = np.array(list(letters))
        self.sentences = _Deck(*mix["sentences"], self.rng)
        self.words = _Deck(*mix["words"], self.rng)
        self.chars = _Deck(*mix["letters"], self.rng)

    def text(self) -> str:
        out = []
        for _ in range(self.sentences.draw()):
            words = ["".join(self.rng.choice(self.letters, self.chars.draw()))
                     for _ in range(self.words.draw())]
            out.append(" ".join(words) + ".")
        return " ".join(out)


def voice_clip(seed: int, sr: int, seconds: float = 6.0) -> np.ndarray:
    """A seeded voice-like clip: a harmonic source on a wandering pitch
    (90-220 Hz), shaped into syllables by a random envelope, over a low
    noise floor, with 0.3 s of the floor alone at each end."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 155.0 + 50.0 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t
                               + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    amp = 1.0 / np.arange(1, 13)
    voice = sum(a * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
                for h, a in enumerate(amp, start=1))
    syll = np.repeat(rng.uniform(0.2, 1.0, n // 4000 + 1), 4000)[:n]
    env = np.convolve(syll, np.hanning(2001) / np.hanning(2001).sum(),
                      mode="same")
    edge = int(0.3 * sr)
    env[:edge] = 0.0
    env[-edge:] = 0.0
    clip = 0.25 * voice * env + 0.003 * rng.standard_normal(n)
    return clip.astype(np.float32)
