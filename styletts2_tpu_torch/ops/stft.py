"""DSP in plain PyTorch: framing, DFT/mel bases, log-mel, interpolation.

Counterpart of styletts2_tpu/ops/stft.py for the functions the inference
slice needs. The mel front end reproduces torchaudio's MelSpectrogram
(n_fft 2048, win 1200, hop 300, power 2, htk mels, no norm) followed by
the reference's log normalisation, as two true-f32 matmuls against
windowed DFT bases. `preprocess_wave` routes to kernel B2
(ops/mel_kernel.py) on CUDA tensors and to its plain version on CPU ones.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

LOG_MEL_MEAN = -4.0
LOG_MEL_STD = 4.0


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_fft) frames, reflect-padded by n_fft // 2
    on both sides (torch.stft center=True parity). Returns a view."""
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, n_fft, hop_length)


def hann_window(win_length: int, n_fft: int) -> torch.Tensor:
    """Periodic Hann window, f32, zero-padded to n_fft with the window
    centred in the frame (torch.stft parity)."""
    n = torch.arange(win_length, dtype=torch.float32)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)
    left = (n_fft - win_length) // 2
    return F.pad(w, (left, n_fft - win_length - left))


@functools.lru_cache(maxsize=None)
def dft_bases(n_fft: int, win_length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(win*cos, win*-sin) bases of shape (n_fft, n_fft // 2 + 1), f32.

    The angle index n*k is reduced mod n_fft in integers before the trig
    (cos of ~6e3 rad in f32 loses ~4e-4 to argument reduction), and the
    DC/Nyquist imaginary columns are exact zeros."""
    freq_bins = n_fft // 2 + 1
    window = hann_window(win_length, n_fft)
    n = torch.arange(n_fft, dtype=torch.int64)[:, None]
    k = torch.arange(freq_bins, dtype=torch.int64)[None, :]
    angle = (2.0 * math.pi / n_fft) * ((n * k) % n_fft).to(torch.float32)
    cos_b = torch.cos(angle) * window[:, None]
    sin_b = -torch.sin(angle) * window[:, None]
    sin_b[:, 0] = 0.0
    if n_fft % 2 == 0:
        sin_b[:, -1] = 0.0
    return cos_b, sin_b


def _linspace0_f32(stop: np.float32, n: int) -> np.ndarray:
    """f32 [0, stop] grid of n points as (stop / (n-1)) * i, the rounding
    of the JAX package's in-graph linspace."""
    step = np.float32(stop / np.float32(n - 1))
    return np.append(step * np.arange(n - 1, dtype=np.float32),
                     np.float32(stop)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int = 24000, n_fft: int = 2048,
                   n_mels: int = 80) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) htk triangular filterbank, f_min 0,
    f_max sr/2, norm None (torchaudio melscale_fbanks), built in f32 with
    the roundings of the JAX package's in-graph filterbank. The narrow
    low filters of a 128-mel bank at n_fft 512 span about one bin, so the
    bank's own f32 rounding moves their log-mels by up to ~5e-5: building
    it with the reference's roundings keeps the two mel front ends within
    the kernels' 2e-5 tolerance."""
    f32 = np.float32
    all_freqs = _linspace0_f32(f32(sr / 2.0), n_fft // 2 + 1)
    m_max = f32(2595.0) * f32(np.log(f32(1.0 + (sr / 2.0) / 700.0))
                              / f32(math.log(10.0)))
    m_pts = _linspace0_f32(m_max, n_mels + 2)
    # correctly rounded f32 power
    p = (10.0 ** (m_pts / f32(2595.0)).astype(np.float64)).astype(f32)
    f_pts = f32(700.0) * (p - f32(1.0))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(f32(0.0), np.minimum(down, up)).astype(f32)


def stft_power(x: torch.Tensor, n_fft: int, hop_length: int,
               win_length: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, freq_bins) power spectrum, true f32."""
    frames = frame_signal(x.float(), n_fft, hop_length)
    cos_b, sin_b = (b.to(x.device) for b in dft_bases(n_fft, win_length))
    re = torch.matmul(frames, cos_b)
    im = torch.matmul(frames, sin_b)
    return re * re + im * im


def mel_spectrogram(wave: torch.Tensor, sr: int = 24000, n_fft: int = 2048,
                    win_length: int = 1200, hop_length: int = 300,
                    n_mels: int = 80) -> torch.Tensor:
    """(B, T) -> (B, n_mels, n_frames) power mel spectrogram."""
    power = stft_power(wave, n_fft, hop_length, win_length)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(wave.device)
    return torch.matmul(power, fb).transpose(1, 2)


def log_mel_normalize(mel: torch.Tensor, mean: float = LOG_MEL_MEAN,
                      std: float = LOG_MEL_STD) -> torch.Tensor:
    return (torch.log(1e-5 + mel) - mean) / std


def preprocess_wave(wave: torch.Tensor, **mel_kwargs) -> torch.Tensor:
    """(B, T) waveforms -> (B, n_mels, n_frames) normalised log-mels: kernel
    B2 on CUDA tensors, its plain version on CPU tensors."""
    from styletts2_tpu_torch.ops.mel_kernel import log_mel

    return log_mel(wave, **mel_kwargs)


# ---------------------------------------------------------------------------
# interpolation (torch.nn.functional.interpolate parity, closed forms of
# styletts2_tpu/ops/stft.py)
# ---------------------------------------------------------------------------


def _interp_linear_int_up(x: torch.Tensor, u: int) -> torch.Tensor:
    """Integer-factor linear upsample, align_corners=False: output q*u + r
    blends source q with its left or right neighbour at a fixed per-phase
    weight (edge-clamped), written as q + fr for better f32 conditioning."""
    n = x.shape[-1]
    # built on x's device: a host-to-device copy would break graph capture
    fr = (torch.arange(u, dtype=torch.float32, device=x.device) + 0.5) / u - 0.5
    use_prev = fr < 0
    w = torch.abs(fr).to(x.dtype)
    x_prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    x_next = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    nb = torch.where(use_prev, x_prev[..., None], x_next[..., None])
    out = x[..., None] * (1.0 - w) + nb * w
    return out.reshape(x.shape[:-1] + (n * u,))


def interpolate_linear(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """1-D linear resize on the last axis, align_corners=False (source
    position of output i is (i + 0.5) * in/out - 0.5, edge-clamped).
    Integer up/down factors take the gather-free closed forms."""
    in_size = x.shape[-1]
    if out_size > in_size and out_size % in_size == 0:
        return _interp_linear_int_up(x, out_size // in_size)
    if out_size <= in_size and in_size % out_size == 0:
        d = in_size // out_size
        if d % 2 == 1:
            return x[..., (d - 1) // 2::d]
        lo = x[..., d // 2 - 1::d]
        hi = x[..., d // 2::d]
        return lo + (hi - lo) * 0.5
    scale = in_size / out_size
    pos = (torch.arange(out_size, dtype=torch.float32, device=x.device)
           + 0.5) * scale - 0.5
    lo = torch.clamp(torch.floor(pos).long(), 0, in_size - 1)
    hi = torch.clamp(lo + 1, 0, in_size - 1)
    frac = torch.clamp(pos - torch.floor(pos), 0.0, 1.0)
    frac = torch.where(pos < 0, torch.zeros_like(frac), frac)
    xl = x[..., lo]
    xh = x[..., hi]
    return xl + (xh - xl) * frac.to(x.dtype)


def interpolate_nearest(x: torch.Tensor, scale_factor: int) -> torch.Tensor:
    """Nearest-neighbour integer upsample on the last axis (== repeat)."""
    return torch.repeat_interleave(x, scale_factor, dim=-1)
