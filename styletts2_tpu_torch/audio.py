"""Host-side audio IO and preprocessing for the style path and the
training data.

The port's own copy of the functions of styletts2_tpu/audio.py that
`StyleTTS2.compute_style` and the training loader need: WAV reading and
writing, header-only length probing, resampling, silence trimming and the
spectral-gate denoiser. Pure numpy/scipy, per clip, not hot. FLAC input
(styletts2_tpu/flac.py) is not ported yet.
"""

from __future__ import annotations

import math
import os
import struct
import wave as _wave
from typing import Tuple

import numpy as np


def _parse_wav_header(data: bytes):
    """RIFF/WAVE parse -> (fmt_tag, channels, sr, bits, data_off, data_len).

    Handles PCM (1), IEEE float (3) and WAVE_FORMAT_EXTENSIBLE (0xFFFE,
    resolved via the subformat GUID)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    while pos + 8 <= len(data):
        cid = data[pos: pos + 4]
        size = int.from_bytes(data[pos + 4: pos + 8], "little")
        body = pos + 8
        if cid == b"fmt ":
            tag, ch, sr = struct.unpack_from("<HHI", data, body)
            bits = struct.unpack_from("<H", data, body + 14)[0]
            if tag == 0xFFFE and size >= 40:  # extensible: real tag in GUID
                tag = struct.unpack_from("<H", data, body + 24)[0]
            fmt = (tag, ch, sr, bits)
        elif cid == b"data":
            if fmt is None:
                raise ValueError("WAV data chunk before fmt chunk")
            return fmt + (body, min(size, len(data) - body))
        pos = body + size + (size & 1)  # chunks are word-aligned
    raise ValueError("WAV file has no data chunk")


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample rate).

    PCM 8/16/24/32-bit int + 32/64-bit IEEE float; first channel of
    multi-channel audio."""
    with open(path, "rb") as f:
        raw_all = f.read()
    tag, ch, sr, bits, off, length = _parse_wav_header(raw_all)
    raw = raw_all[off: off + length]
    if tag == 3:  # IEEE float
        if bits == 32:
            data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            data = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float WAV bit depth {bits}")
    elif tag == 1:  # PCM
        if bits == 16:
            data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                    - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            data = v.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM WAV bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag {tag}")
    if ch > 1:
        data = data.reshape(-1, ch)[:, 0]
    return data, sr


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Read an audio file -> (float32 mono, sr). WAV only: a FLAC file
    raises (its decoder is not ported yet)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        raise NotImplementedError(f"{path}: FLAC input is not ported yet; "
                                  "convert it to WAV")
    return read_wav(path)


def probe_duration_samples(path: str, target_sr: int) -> int:
    """Sample count at target_sr from the WAV header only (no decode): feeds
    the duration-binned sampler (reference get_length,
    meldataset.py:181-183)."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)  # headers live in the first chunk
    if data[:4] == b"fLaC":
        raise NotImplementedError(f"{path}: FLAC input is not ported yet; "
                                  "convert it to WAV")
    try:
        tag, ch, sr, bits, off, _ = _parse_wav_header(data)
    except ValueError:
        with open(path, "rb") as f:
            data = f.read()
        tag, ch, sr, bits, off, _ = _parse_wav_header(data)
    n = (os.path.getsize(path) - off) // (ch * (bits // 8))
    return int(n * (target_sr / sr))


def write_wav(path: str, wav: np.ndarray, sr: int = 24000) -> None:
    """Write 16-bit PCM mono, clipped to [-1, 1]."""
    wav = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    pcm = (wav * 32767.0).astype("<i2")
    with _wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def trim_silence(wav: np.ndarray, top_db: float = 30.0,
                 frame_length: int = 2048, hop_length: int = 512
                 ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """librosa.effects.trim parity: drop leading/trailing frames more than
    top_db below the peak RMS."""
    if len(wav) == 0:
        return wav, (0, 0)
    pad = frame_length // 2
    padded = np.pad(wav.astype(np.float32), (pad, pad))
    n_frames = 1 + (len(padded) - frame_length) // hop_length
    idx = (np.arange(n_frames) * hop_length)[:, None] + np.arange(frame_length)
    rms = np.sqrt(np.mean(padded[idx] ** 2, axis=1))
    ref = rms.max()
    if ref <= 0:
        return wav, (0, len(wav))
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref)
    keep = np.nonzero(db > -top_db)[0]
    if len(keep) == 0:
        return wav[:0], (0, 0)
    start = int(keep[0] * hop_length)
    end = int(min(len(wav), (keep[-1] + 1) * hop_length))
    return wav[start:end], (start, end)


def spectral_gate_denoise(wav: np.ndarray, sr: int,
                          prop_decrease: float = 1.0, n_fft: int = 1024,
                          hop_length: int = 256,
                          n_std_thresh: float = 1.5,
                          freq_smooth_hz: float = 500.0,
                          time_smooth_ms: float = 50.0) -> np.ndarray:
    """Stationary spectral-gate denoiser (noisereduce's
    SpectralGateStationary algorithm): STFT -> per-bin noise floor from the
    quietest fifth of the frames -> binary keep-mask -> triangular
    time/frequency smoothing -> scale by prop_decrease -> masked iSTFT."""
    wav = np.asarray(wav, dtype=np.float32)
    if len(wav) < n_fft:
        return wav
    from scipy.signal import fftconvolve
    from scipy.signal import istft as _istft
    from scipy.signal import stft as _stft

    _, _, spec = _stft(wav, nperseg=n_fft, noverlap=n_fft - hop_length,
                       padded=True)
    mag_db = 20.0 * np.log10(np.maximum(np.abs(spec), 1e-10))

    energy = mag_db.mean(axis=0)
    n_quiet = max(4, len(energy) // 5)
    quiet = mag_db[:, np.argsort(energy)[:n_quiet]]
    thresh = quiet.mean(axis=1) + n_std_thresh * quiet.std(axis=1)
    keep = (mag_db > thresh[:, None]).astype(np.float32)

    n_freq = int(freq_smooth_hz / (sr / 2.0 / (n_fft // 2 + 1)))
    n_time = int(time_smooth_ms / 1000.0 * sr / hop_length)

    def _tri(n: int) -> np.ndarray:
        if n < 1:
            return np.ones(1, np.float32)
        up = np.linspace(0.0, 1.0, n + 2)[1:-1]
        w = np.concatenate([up, [1.0], up[::-1]]).astype(np.float32)
        return w / w.sum()

    kernel = np.outer(_tri(n_freq), _tri(n_time))
    # smoothing only rolls off outward from kept regions (max with the raw
    # mask): a normalized convolution alone would dilute narrowband keeps
    keep = np.maximum(keep, np.clip(
        fftconvolve(keep, kernel, mode="same"), 0.0, 1.0))

    gain = keep * prop_decrease + (1.0 - prop_decrease)
    _, den = _istft(spec * gain, nperseg=n_fft,
                    noverlap=n_fft - hop_length)
    den = den[: len(wav)].astype(np.float32)
    if len(den) < len(wav):
        den = np.pad(den, (0, len(wav) - len(den)))
    return den


def maybe_denoise(wav: np.ndarray, sr: int, amount: float) -> np.ndarray:
    """Blend with a denoised copy: `audio * (1 - d) + denoised * d`."""
    if amount <= 0:
        return wav
    den = spectral_gate_denoise(wav, sr)
    return (wav * (1.0 - amount) + den * amount).astype(np.float32)
