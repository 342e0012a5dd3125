"""Text and voice front end of the reference: the symbol table, text
cleaning, sentence chunking and word tokenization of StyleTTS2-lite's
inference.py, and the voice clip's silence trim, spectral-gate denoise
and log-mel (torchaudio's MelSpectrogram: n_fft 2048, win 1200, hop 300,
power 2, htk mels, no norm; then log(1e-5 + mel), mean -4, std 4).
Plain Python, NumPy, SciPy and torch.stft.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping

import numpy as np
import torch

# ---------------------------------------------------------------- text


def symbol_dict(symbol: Mapping[str, str]) -> Dict[str, int]:
    """char -> id in the order pad, punctuation, letters, letters_ipa,
    extend (reference train.py:67-83)."""
    chars = (list(symbol["pad"]) + list(symbol["punctuation"])
             + list(symbol["letters"]) + list(symbol["letters_ipa"])
             + list(symbol.get("extend", "")))
    return {c: i for i, c in enumerate(chars)}


_COMMA_LIKE = ["，", "、", "،", ";", "(", "．", "。", "…", "!", "–", ":", "?"]
_PUNCT = re.compile("[" + "".join(re.escape(p) for p in _COMMA_LIKE) + "]")
# the Treebank-style split of word_tokenize (contractions, lexicalized
# forms, hyphenated words, any other non-space character on its own)
_WORD = re.compile(
    r"(?i)\w+(?=n't\b)|n't\b|'(?:ll|re|ve|s|m|d)\b"
    r"|\b(?:can(?=not\b)|gon(?=na\b)|wan(?=na\b)|got(?=ta\b)"
    r"|gim(?=me\b)|lem(?=me\b))"
    r"|\w+(?:-\w+|'(?!(?:ll|re|ve|s|m|d)\b)\w+)*|[^\w\s]", re.UNICODE)


def split_into_chunks(text: str, n_merge: int) -> List[str]:
    """Comma- and period-like punctuation to '.', whitespace squeezed,
    split on '.', empty parts dropped, then consecutive sentences merged
    with ", " until each has n_merge words (a short tail joins the chunk
    before it)."""
    text = re.sub(r"\s+", " ", _PUNCT.sub(".", text)).strip()
    parts = [p.strip() for p in text.split(".")]
    parts = [p for p in parts if p]
    merged: List[str] = []
    i = 0
    while i < len(parts):
        frag, j = parts[i], i + 1
        while len(frag.split()) < n_merge and j < len(parts):
            frag += ", " + parts[j]
            j += 1
        merged.append(frag)
        i = j
    if len(merged) > 1 and len(merged[-1].split()) < n_merge:
        merged[-2] = merged[-2] + ", " + merged[-1]
        del merged[-1]
    return merged


def tokens(sentence: str, symbols: Mapping[str, int]) -> List[int]:
    """Words and punctuation joined by spaces, mapped to ids (unknown
    characters dropped), wrapped in pad ids."""
    phonem = " ".join(_WORD.findall(sentence))
    return [0] + [symbols[c] for c in phonem if c in symbols] + [0]


# ---------------------------------------------------------------- voice


def trim_silence(wav: np.ndarray, top_db: float = 30.0, frame: int = 2048,
                 hop: int = 512) -> np.ndarray:
    """Leading and trailing frames more than top_db below the loudest
    frame's RMS dropped (librosa.effects.trim)."""
    pad = frame // 2
    padded = np.pad(wav.astype(np.float32), (pad, pad))
    n = 1 + (len(padded) - frame) // hop
    idx = (np.arange(n) * hop)[:, None] + np.arange(frame)
    rms = np.sqrt(np.mean(padded[idx] ** 2, axis=1))
    if rms.max() <= 0:
        return wav
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / rms.max())
    keep = np.nonzero(db > -top_db)[0]
    if len(keep) == 0:
        return wav[:0]
    return wav[int(keep[0] * hop): int(min(len(wav), (keep[-1] + 1) * hop))]


def spectral_gate(wav: np.ndarray, sr: int, n_fft: int = 1024,
                  hop: int = 256, n_std: float = 1.5,
                  freq_hz: float = 500.0, time_ms: float = 50.0
                  ) -> np.ndarray:
    """Stationary spectral gate (noisereduce's SpectralGateStationary):
    per-bin floor from the quietest fifth of the frames, a keep mask,
    triangular time/frequency smoothing that only rolls off outward, and
    the masked iSTFT."""
    from scipy.signal import fftconvolve, istft, stft

    wav = np.asarray(wav, np.float32)
    if len(wav) < n_fft:
        return wav
    _, _, spec = stft(wav, nperseg=n_fft, noverlap=n_fft - hop, padded=True)
    mag_db = 20.0 * np.log10(np.maximum(np.abs(spec), 1e-10))
    energy = mag_db.mean(axis=0)
    quiet = mag_db[:, np.argsort(energy)[:max(4, len(energy) // 5)]]
    keep = (mag_db > (quiet.mean(axis=1) + n_std * quiet.std(axis=1))[:, None]
            ).astype(np.float32)

    def tri(n):
        if n < 1:
            return np.ones(1, np.float32)
        up = np.linspace(0.0, 1.0, n + 2)[1:-1]
        w = np.concatenate([up, [1.0], up[::-1]]).astype(np.float32)
        return w / w.sum()

    kern = np.outer(tri(int(freq_hz / (sr / 2.0 / (n_fft // 2 + 1)))),
                    tri(int(time_ms / 1000.0 * sr / hop)))
    keep = np.maximum(keep, np.clip(fftconvolve(keep, kern, mode="same"),
                                    0.0, 1.0))
    _, den = istft(spec * keep, nperseg=n_fft, noverlap=n_fft - hop)
    den = den[: len(wav)].astype(np.float32)
    return np.pad(den, (0, len(wav) - len(den)))


def style_windows(wave: np.ndarray, sr: int, denoise: float = 0.3
                  ) -> List[np.ndarray]:
    """The clip as the style encoder sees it: trimmed (top 30 dB), capped
    at 20 s, blended with its denoised copy, then 3-s windows plus a tail
    of its whole seconds when >= 1 s is left (clips of 4 s or more), else
    its whole seconds. Returns the batches whose styles are averaged, each
    (n, samples), so every window counts once."""
    audio = trim_silence(np.asarray(wave, np.float32))[: sr * 20]
    if denoise > 0:
        audio = (audio * (1.0 - denoise)
                 + spectral_gate(audio, sr) * denoise).astype(np.float32)
    if len(audio) / sr >= 4:
        jump = 3 * sr
        n = len(audio) // jump
        out = [audio[: n * jump].reshape(n, jump)]
        left = len(audio) - n * jump
        if left >= sr:
            out.append(audio[n * jump: n * jump + (left // sr) * sr][None])
        return out
    return [audio[: max(1, len(audio) // sr) * sr][None]]


def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) htk triangles from 0 to sr / 2, no norm."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    m_max = 2595.0 * math.log10(1.0 + (sr / 2.0) / 700.0)
    f_pts = 700.0 * (10.0 ** (np.linspace(0.0, m_max, n_mels + 2) / 2595.0)
                     - 1.0)
    slopes = f_pts[None, :] - freqs[:, None]
    f_diff = np.diff(f_pts)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def log_mel(wave: torch.Tensor, sr: int, n_fft: int, win: int, hop: int,
            n_mels: int) -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames) normalised log-mel."""
    spec = torch.stft(wave, n_fft=n_fft, hop_length=hop, win_length=win,
                      window=torch.hann_window(win, device=wave.device),
                      center=True, pad_mode="reflect", return_complex=True)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(wave.device)
    mel = torch.matmul(fb.T, spec.abs() ** 2)
    return (torch.log(1e-5 + mel) + 4.0) / 4.0

