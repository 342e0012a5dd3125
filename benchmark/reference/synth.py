"""What the engine's entry points return, worked out by the reference, and
the comparison of the program's audio with it.

`StyleTTS2.generate(text)` (one sentence, one chunk): the chunk's
stabilisation draws come from default_rng([base_seed, 0]); the waveform
is int16 PCM / 32767 with its first and last 4000 samples zeroed.
`StyleTTS2.serve` / `generate_batch`: text i of a batch draws from
default_rng([base_seed, i]), its chunks chain their duration means, and
its waveform is the chunks' middles ([4000:-4000]) between 4000 zeros.
base_seed is the engine's k-th draw of integers(2**63) from
default_rng(engine seed): one per `generate` call and one per batch.

A float duration within TAU of a rounding boundary may round the other
way in the program, whose float32 arithmetic differs in the last bits:
such a chunk is rendered for each way (at most 2**MAX_AMBIGUOUS) and the
one closest to the program's audio is compared.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from benchmark.reference import frontend as FE
from benchmark.reference.model import Reference, durations

EDGE = 4000
TAU = 2e-4
MAX_AMBIGUOUS = 3


def base_seeds(engine_seed: int, n: int) -> List[int]:
    """The engine's first n synthesis seeds."""
    rng = np.random.default_rng(engine_seed)
    return [int(rng.integers(2 ** 63)) for _ in range(n)]


@dataclass
class Chunk:
    t_en: object
    d: object
    dur: np.ndarray     # float durations before rounding
    pred: np.ndarray    # integer durations


def plan_text(ref: Reference, text: str, s, scale: float, base_seed: int,
              chain: int, n_merge: int, t: float = 0.2,
              speed: float = 1.0) -> List[Chunk]:
    """Phase 1 and the duration glue of every chunk of one text."""
    rng = np.random.default_rng([base_seed, chain])
    prev = 0.0
    out = []
    for sentence in FE.split_into_chunks(text, n_merge):
        t_en, d, raw = ref.phase1(FE.tokens(sentence, ref.symbols), s)
        dur, pred, prev = durations(raw, scale, speed, prev, t, rng)
        out.append(Chunk(t_en, d, dur, pred))
    return out


def _roundings(c: Chunk):
    """The chunk's integer durations, then each other rounding of its
    ambiguous tokens (the MAX_AMBIGUOUS nearest their boundary)."""
    yield c.pred
    dist = np.abs(c.dur - (np.floor(c.dur) + 0.5))
    amb = [i for i in np.argsort(dist)[:MAX_AMBIGUOUS]
           if dist[i] < TAU and c.dur[i] > 0.5]
    for flips in itertools.product((0, 1), repeat=len(amb)):
        if not any(flips):
            continue
        alt = c.pred.copy()
        for i, f in zip(amb, flips):
            if f:
                alt[i] = (np.floor(c.dur[i]) if alt[i] > c.dur[i]
                          else np.ceil(c.dur[i]))
        yield np.clip(alt, 1, None)


@dataclass
class Verdict:
    err_rms: float       # RMS of the program's error, in full-scale units
    gap: float           # the same error over the reference's AC part
    length_ok: bool
    frames: int          # the reference's frames (sum of durations)
    rms: float           # the reference audio's RMS
    dc: float            # the reference audio's mean
    clipped: float       # share of the reference's samples at full scale


def compare(ref: Reference, chunks: Sequence[Chunk], s,
            out: np.ndarray) -> Verdict:
    """The program's waveform `out` against the reference's: per chunk
    the rounding whose audio lies closest, its middle at the chunk's
    offset. Over the chunks' middles: err_rms, the RMS of out - ref in
    units of full scale (the number a run compares: a random decoder's
    level differs from seed to seed, its rounding error much less), and
    gap = ||out - ref|| / ||ref - mean(ref)||, the error against the
    audio's varying part; both inf when the lengths differ."""
    off = EDGE
    err2 = 0.0
    acc = np.zeros(3)                 # n, sum, sum of squares of the mids
    frames = clipped = n_samples = 0
    for c in chunks:
        best = None
        for pred in _roundings(c):
            pcm = ref.phase2(c.t_en, c.d, s, pred)
            mid = pcm.astype(np.float32)[EDGE: len(pcm) - EDGE] / 32767.0
            got = out[off: off + len(mid)]
            if len(got) != len(mid):
                continue
            e2 = float(np.sum((got.astype(np.float64) - mid) ** 2))
            if best is None or e2 < best[0]:
                best = (e2, mid, pcm, int(pred.sum()))
        if best is None:
            return Verdict(float("inf"), float("inf"), False, frames, 0.0,
                           0.0, 0.0)
        e2, mid, pcm, n = best
        err2 += e2
        m64 = mid.astype(np.float64)
        acc += (len(m64), m64.sum(), np.sum(m64 * m64))
        frames += n
        if n * 2 * ref.hop != len(pcm):
            raise RuntimeError(f"reference PCM of {len(pcm)} samples for "
                               f"{n} frames")
        clipped += int(np.sum(np.abs(pcm.astype(np.int32)) >= 32766))
        n_samples += len(pcm)
        off += len(mid)
    n, total, sq = acc
    mean = total / max(n, 1)
    ac2 = max(sq - n * mean * mean, 1e-30)
    length_ok = off + EDGE == len(out)
    inf = float("inf")
    gap = np.sqrt(err2 / ac2) if length_ok else inf
    err_rms = np.sqrt(err2 / max(n, 1)) if length_ok else inf
    return Verdict(float(err_rms), float(gap), length_ok, frames,
                   float(np.sqrt(sq / max(n, 1))), float(mean),
                   clipped / max(n_samples, 1))
