"""DSP in plain PyTorch: framing, DFT/mel bases, log-mel, the iSTFTNet
and Vocos STFT/iSTFT heads, interpolation.

Counterpart of styletts2_tpu/ops/stft.py. The mel front end reproduces
torchaudio's MelSpectrogram (n_fft 2048, win 1200, hop 300, power 2, htk
mels, no norm) followed by the reference's log normalisation, as two
true-f32 matmuls against windowed DFT bases. `preprocess_wave` routes to
kernel B2 (ops/mel_kernel.py) on CUDA tensors and to its plain version on
CPU ones. The forward STFT of iSTFTNet's harmonic source and both inverse
STFTs are matmuls against windowed (inverse-)DFT bases and an overlap-add
of K = frame_len / hop shifted adds: no host sync and no host copy once
the bases are cached on the device, so a CUDA graph captures them.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LOG_MEL_MEAN = -4.0
LOG_MEL_STD = 4.0


_CONSTANT_LOCK = threading.RLock()


def cached_constant(fn):
    """functools.lru_cache for tensor constants, each built outside
    inference mode: one first built under torch.inference_mode() (the
    engine's) would be an inference tensor, which autograd refuses to save
    for a later training step's backward. Built once under a lock and
    waited for on the building thread's stream: the engine's capture
    thread may build a constant on its own stream that the serving thread
    then reads on another."""
    @functools.lru_cache(maxsize=None)
    def build(*args, **kwargs):
        with torch.inference_mode(False):
            out = fn(*args, **kwargs)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if (isinstance(t, torch.Tensor) and t.is_cuda
                    and not torch.cuda.is_current_stream_capturing()):
                torch.cuda.current_stream(t.device).synchronize()
        return out

    @functools.wraps(fn)
    def locked(*args, **kwargs):
        with _CONSTANT_LOCK:
            return build(*args, **kwargs)

    locked.cache_clear = build.cache_clear
    return locked


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True,
                 pad_mode: str = "reflect") -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_fft) frames (a view). center: padded by
    n_fft // 2 on both sides (torch.stft parity), by reflection, edge
    replication or zeros."""
    if center:
        if pad_mode not in ("reflect", "replicate", "constant"):
            raise ValueError(f"frame_signal: unknown pad_mode {pad_mode!r}")
        pad = n_fft // 2
        x = F.pad(x[:, None, :], (pad, pad), mode=pad_mode)[:, 0]
    return x.unfold(-1, n_fft, hop_length)


def hann_window(win_length: int, n_fft: int,
                center: bool = True) -> torch.Tensor:
    """Periodic Hann window, f32, zero-padded to n_fft with the window
    centred in the frame (torch.stft parity) or at its start (center
    False: the reference's CustomSTFT and Vocos ISTFT)."""
    n = torch.arange(win_length, dtype=torch.float32)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)
    left = (n_fft - win_length) // 2 if center else 0
    return F.pad(w, (left, n_fft - win_length - left))


def _angles(rows: int, cols: int, n_fft: int) -> torch.Tensor:
    """(rows, cols) f32 angles 2 pi (r * c mod n_fft) / n_fft: the index is
    reduced in integers before the trig (cos of ~6e3 rad in f32 loses
    ~4e-4 to argument reduction)."""
    r = torch.arange(rows, dtype=torch.int64)[:, None]
    c = torch.arange(cols, dtype=torch.int64)[None, :]
    return (2.0 * math.pi / n_fft) * ((r * c) % n_fft).to(torch.float32)


@cached_constant
def dft_bases(n_fft: int, win_length: int, center_window: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(win*cos, win*-sin) bases of shape (n_fft, n_fft // 2 + 1), f32,
    the window centred (torch.stft) or at the frame's start
    (center_window False). The DC/Nyquist imaginary columns are exact
    zeros."""
    window = hann_window(win_length, n_fft, center_window)
    angle = _angles(n_fft, n_fft // 2 + 1, n_fft)
    cos_b = torch.cos(angle) * window[:, None]
    sin_b = -torch.sin(angle) * window[:, None]
    sin_b[:, 0] = 0.0
    if n_fft % 2 == 0:
        sin_b[:, -1] = 0.0
    return cos_b, sin_b


@cached_constant
def _device_dft_bases(n_fft: int, win_length: int, center_window: bool,
                      device: torch.device):
    return tuple(b.to(device) for b in dft_bases(n_fft, win_length,
                                                 center_window))


@cached_constant
def idft_bases(n_fft: int, win_length: int, device: torch.device,
               onesided: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse-DFT bases (n_fft // 2 + 1, n_fft), f32 on `device`:
    cos / sin of the angle times the window (at the frame's start) and
    1 / n_fft. onesided: bins 1 .. n_fft/2 - 1 doubled (the irfft's
    conjugate symmetry folded into the bases, istft_vocos)."""
    freq_bins = n_fft // 2 + 1
    window = hann_window(win_length, n_fft, center=False)[None, :]
    angle = _angles(freq_bins, n_fft, n_fft)
    cos_b = torch.cos(angle) * window * (1.0 / n_fft)
    sin_b = torch.sin(angle) * window * (1.0 / n_fft)
    if onesided:
        k = torch.arange(freq_bins)[:, None]
        inner = (k > 0) & ((k < freq_bins - 1) | (n_fft % 2 == 1))
        fold = torch.where(inner, 2.0, 1.0)
        cos_b, sin_b = cos_b * fold, sin_b * fold
    return cos_b.to(device), sin_b.to(device)


@cached_constant
def _window_envelope(n_frames: int, win_length: int, hop_length: int,
                     device: torch.device) -> torch.Tensor:
    """(1, (n_frames - 1) * hop + win) overlap-add of the squared window."""
    w = hann_window(win_length, win_length)
    return overlap_add((w * w).expand(1, n_frames, win_length),
                       hop_length).to(device)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, n_frames, frame_len) -> (B, (n_frames - 1) * hop + frame_len):
    K = ceil(frame_len / hop) shifted adds of hop-long slices (frames
    zero-padded to K * hop), no scatter."""
    b, t, fl = frames.shape
    k = -(-fl // hop_length)
    if k * hop_length != fl:
        frames = F.pad(frames, (0, k * hop_length - fl))
    chunks = frames.reshape(b, t, k, hop_length)
    out = sum(F.pad(chunks[:, :, c], (0, 0, c, k - 1 - c)) for c in range(k))
    return out.reshape(b, (t + k - 1) * hop_length)[
        :, : (t - 1) * hop_length + fl]


def stft_mag_phase(x: torch.Tensor, n_fft: int, hop_length: int,
                   win_length: int, center: bool = True,
                   pad_mode: str = "replicate"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) f32 -> (magnitude, phase), each (B, n_fft // 2 + 1,
    n_frames): the reference's CustomSTFT.transform (end-padded window,
    eps 1e-14 inside the sqrt). The atan2 branch point is canonicalised as
    in the JAX package: a bin whose |im| <= 1e-3 * magnitude gets phase 0
    (re >= 0) or pi (re < 0), and a bin of magnitude < 1e-5 phase 0."""
    frames = frame_signal(x.float(), n_fft, hop_length, center, pad_mode)
    cos_b, sin_b = _device_dft_bases(n_fft, win_length, False, x.device)
    re = torch.matmul(frames, cos_b).transpose(1, 2)
    im = torch.matmul(frames, sin_b).transpose(1, 2)
    mag = torch.sqrt(re * re + im * im + 1e-14)
    phase = torch.atan2(im, re)
    near_axis = torch.abs(im) <= 1e-3 * mag
    zero = torch.zeros((), device=x.device)
    phase = torch.where(near_axis & (re < 0),
                        torch.full((), math.pi, device=x.device), phase)
    phase = torch.where(near_axis & (re >= 0), zero, phase)
    return mag, torch.where(mag < 1e-5, zero, phase)


def istft_conv(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int,
               hop_length: int, win_length: int,
               frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's CustomSTFT.inverse: (B, n_fft // 2 + 1, n_frames)
    magnitude and phase -> (B, 1, L) f32 waveform. The frames are the real
    and imaginary parts through the windowed inverse-DFT bases, their
    difference overlap-added with no window-envelope division, trimmed by
    n_fft // 2 at both ends (center=True).

    frame_valid: optional (n_frames,) or (B, n_frames) bool; frames marked
    False add nothing to the overlap-add, as if their slots did not exist
    (a sequence-parallel window's slots outside the global grid; with no
    envelope division, zeroing the frames is the whole of it)."""
    real = magnitude * torch.cos(phase)
    imag = magnitude * torch.sin(phase)
    cos_b, sin_b = idft_bases(n_fft, win_length, magnitude.device)
    frames = (torch.matmul(real.transpose(1, 2), cos_b)
              - torch.matmul(imag.transpose(1, 2), sin_b))
    if frame_valid is not None:
        fv = frame_valid if frame_valid.dim() == 2 else frame_valid[None]
        frames = frames * fv[..., None].to(frames.dtype)
    pad = n_fft // 2
    return overlap_add(frames, hop_length)[:, None, pad:-pad]


def istft_vocos(spec_real: torch.Tensor, spec_imag: torch.Tensor,
                n_fft: int, hop_length: int, win_length: int,
                frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vocos's ISTFT with padding 'same': (B, n_fft // 2 + 1, n_frames)
    real and imaginary parts -> (B, L) f32: irfft as matmuls (conjugate
    symmetry folded into the bases), windowed overlap-add, division by the
    squared window's overlap-add (at least 1e-11), trimmed by
    (win - hop) // 2 at both ends.

    frame_valid: optional (B, n_frames) bool; frames marked False add
    neither audio nor window envelope, as if their slots did not exist
    (a sequence-parallel window's slots outside the global sequence; a
    single-device call has none)."""
    cos_b, sin_b = idft_bases(n_fft, win_length, spec_real.device,
                              onesided=True)
    frames = (torch.matmul(spec_real.transpose(1, 2), cos_b)
              - torch.matmul(spec_imag.transpose(1, 2), sin_b))
    if frame_valid is None:
        env = _window_envelope(frames.shape[1], win_length, hop_length,
                               spec_real.device)
    else:
        fv = frame_valid[..., None].to(frames.dtype)  # (B, n_frames, 1)
        frames = frames * fv
        w = hann_window(win_length, win_length).to(spec_real.device)
        env = overlap_add(w * w * fv, hop_length)
    y = overlap_add(frames, hop_length)
    y = y / torch.clamp(env, min=1e-11)
    pad = (win_length - hop_length) // 2
    return y[:, pad:-pad] if pad > 0 else y


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
    B2 on CUDA tensors (differentiable: its backward is autograd over the
    plain formula), its plain version on CPU tensors."""
    from styletts2_tpu_torch.ops.mel_kernel import log_mel

    return log_mel(wave, **mel_kwargs)


def log_norm(x: torch.Tensor, mean: float = LOG_MEL_MEAN,
             std: float = LOG_MEL_STD, dim: int = -2) -> torch.Tensor:
    """Energy curve from normalised log-mels: log ||exp(x * std + mean)||_2
    over the mel axis (reference utils.py:47-53)."""
    return torch.log(torch.linalg.vector_norm(torch.exp(x * std + mean),
                                              dim=dim))


@cached_constant
def dct_matrix(n_mfcc: int = 40, n_mels: int = 80) -> torch.Tensor:
    """(n_mels, n_mfcc) orthonormal DCT-II basis, f32
    (torchaudio.functional.create_dct(norm='ortho') parity)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    dct[:, 0] *= 1.0 / math.sqrt(2.0)
    dct *= math.sqrt(2.0 / n_mels)
    return torch.from_numpy(dct.astype(np.float32))


def mfcc(mel_norm: torch.Tensor, n_mfcc: int = 40) -> torch.Tensor:
    """(B, n_mels, T) normalised log-mel -> (B, n_mfcc, T): a plain DCT
    matmul (reference ASR/layers.py:341-354)."""
    d = dct_matrix(n_mfcc, mel_norm.shape[-2]).to(mel_norm.device)
    return torch.matmul(mel_norm.transpose(-1, -2), d).transpose(-1, -2)


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
