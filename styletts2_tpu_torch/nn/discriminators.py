"""Waveform discriminators: multi-period (MPD) and multi-resolution
spectrogram (MSD).

Counterpart of styletts2_tpu/nn/discriminators.py (reference
Modules/discriminators.py:11-156). State-dict keys mirror the JAX param
trees; every conv is weight-normed (`layers.wn`). NCHW: MPD folds the
wave to (B, 1, T / period, period), MSD takes |STFT| as (B, 1, frames,
freq). Each forward returns (real logits, fake logits, real feature maps,
fake feature maps), lists over the sub-discriminators.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.ops import stft as OPS

LRELU_SLOPE = 0.1
MPD_PERIODS = (2, 3, 5, 7, 11)
MSD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
_MPD_CHANNELS = (1, 32, 128, 512, 1024, 1024)


def _conv2d(cin, cout, k, stride=(1, 1), padding=(0, 0)) -> nn.Conv2d:
    return L.wn(nn.Conv2d(cin, cout, k, stride=stride, padding=padding))


def _stack(convs: nn.ModuleList, post: nn.Module, x: torch.Tensor
           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    fmap = []
    for conv in convs:
        x = L.leaky_relu(L.conv2d(conv, x), LRELU_SLOPE)
        fmap.append(x)
    x = L.conv2d(post, x)
    fmap.append(x)
    return x.flatten(1), fmap


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        self.convs = nn.ModuleList([
            _conv2d(_MPD_CHANNELS[i], _MPD_CHANNELS[i + 1], (kernel_size, 1),
                    (stride if i < 4 else 1, 1), (pad if i < 4 else 2, 0))
            for i in range(5)])
        self.conv_post = _conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, wav: torch.Tensor):
        """wav (B, T): reflect-pad T to a multiple of the period (torch's
        reflect excludes the edge sample), fold, run the (k, 1) stack."""
        b, t = wav.shape
        if t % self.period:
            wav = F.pad(wav[:, None], (0, self.period - t % self.period),
                        mode="reflect")[:, 0]
        return _stack(self.convs, self.conv_post,
                      wav.reshape(b, 1, -1, self.period))


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorP(p) for p in MPD_PERIODS])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat (B, T)."""
        return _both(self.discriminators, y, y_hat)


class SpecDiscriminator(nn.Module):
    def __init__(self, fft_size: int, hop: int, win: int):
        super().__init__()
        self.res = (fft_size, hop, win)
        shapes = [(1, 32), (32, 32), (32, 32), (32, 32), (32, 32)]
        strides = [(1, 1), (1, 2), (1, 2), (1, 2), (1, 1)]
        self.discriminators = nn.ModuleList([
            _conv2d(ci, co, (3, 9) if i < 4 else (3, 3), strides[i],
                    (1, 4) if i < 4 else (1, 1))
            for i, (ci, co) in enumerate(shapes)])
        self.out = _conv2d(32, 1, (3, 3), padding=(1, 1))

    def forward(self, wav: torch.Tensor):
        """wav (B, T) -> |STFT| (B, 1, frames, freq) -> conv stack."""
        fft, hop, win = self.res
        mag = torch.sqrt(OPS.stft_power(wav.float(), fft, hop, win) + 1e-14)
        return _stack(self.discriminators, self.out, mag[:, None].to(wav.dtype))


class MultiResSpecDiscriminator(nn.Module):
    def __init__(self):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [SpecDiscriminator(*r) for r in MSD_RESOLUTIONS])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat (B, T)."""
        return _both(self.discriminators, y, y_hat)


def _both(discs: nn.ModuleList, y: torch.Tensor, y_hat: torch.Tensor):
    rs, gs, frs, fgs = [], [], [], []
    for d in discs:
        r, fr = d(y)
        g, fg = d(y_hat)
        rs.append(r)
        gs.append(g)
        frs.append(fr)
        fgs.append(fg)
    return rs, gs, frs, fgs
