"""The traffic generator: the same seed gives the same texts, and every
size lies in the mix's stated ranges."""

import json

import numpy as np
import pytest

from benchmark.harness.traffic import Texts, alphabet, voice_clip
from benchmark.reference import frontend as FE
from conftest import BENCH, tiny_config

SYMBOL = tiny_config()["symbol"]


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["interactive", "serve_b16"])
def test_same_seed_same_texts(name):
    a = Texts(mix(name), alphabet(SYMBOL), 2 ** 31 + 5)
    b = Texts(mix(name), alphabet(SYMBOL), 2 ** 31 + 5)
    c = Texts(mix(name), alphabet(SYMBOL), 2 ** 31 + 6)
    ta = [a.text() for _ in range(40)]
    assert ta == [b.text() for _ in range(40)]
    assert ta != [c.text() for _ in range(40)]


@pytest.mark.parametrize("name", ["interactive", "serve_b16"])
def test_sizes_in_range(name):
    m = mix(name)
    texts = Texts(m, alphabet(SYMBOL), 12345)
    symbols = FE.symbol_dict(SYMBOL)
    seen_words = set()
    for _ in range(200):
        text = texts.text()
        sentences = [s for s in text.split(".") if s.strip()]
        assert m["sentences"][0] <= len(sentences) <= m["sentences"][1]
        for s in sentences:
            words = s.split()
            seen_words.add(len(words))
            assert m["words"][0] <= len(words) <= m["words"][1]
            for w in words:
                assert m["letters"][0] <= len(w) <= m["letters"][1]
                assert all(c in symbols for c in w)
        for chunk in FE.split_into_chunks(text, m["n_merge"]):
            # every chunk fits the engine's largest token bucket (512)
            assert len(FE.tokens(chunk, symbols)) <= 512
    # the deck deals every size of the range
    assert seen_words == set(range(m["words"][0], m["words"][1] + 1))


def test_interactive_is_one_chunk_per_text():
    m = mix("interactive")
    texts = Texts(m, alphabet(SYMBOL), 7)
    for _ in range(100):
        assert len(FE.split_into_chunks(texts.text(), m["n_merge"])) == 1


def test_same_sizes_for_every_seed():
    """Seeds deal the same sizes in another order: 25 texts of a round of
    the words deck have the same word counts whatever the seed."""
    m = mix("interactive")
    counts = []
    for seed in (1, 2, 2 ** 40):
        t = Texts(m, alphabet(SYMBOL), seed)
        counts.append(sorted(len(t.text().split()) for _ in range(25)))
    assert counts[0] == counts[1] == counts[2]


def test_voice_clip_is_seeded():
    a, b = voice_clip(3, 24000), voice_clip(3, 24000)
    assert a.shape == (144000,) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, voice_clip(4, 24000))
    # trimming keeps most of it: the floor alone only at the ends
    assert len(FE.trim_silence(a)) > 0.8 * len(a)
