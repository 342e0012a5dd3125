"""Vocos generator: a constant-resolution ConvNeXt stack and an iSTFT head.

Counterpart of styletts2_tpu/nn/vocos.py (reference Modules/vocos.py:
ConvNeXtBlock, Generator, ISTFTHead with 'same' padding). No harmonic
source and no kernel B1: its convolutions are a depthwise k = 7 conv and
two pointwise linears per block. The frame mask only keeps the AdaIN
statistics to the valid frames; the padded frames still contribute to
the overlap-add (the engine trims the output), as in the JAX package on
one device. Channels-last activations.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from styletts2_tpu_torch.config import DecoderConfig
from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.ops import stft as OPS


class ConvNeXtBlock(nn.Module):
    """mask -> depthwise conv k7 -> AdaIN -> Linear -> GELU -> Linear ->
    layer scale `gamma` -> residual."""

    def __init__(self, dim: int, intermediate_dim: int,
                 layer_scale_init_value: float, style_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = L.AdaIN1d(style_dim, dim)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x
        if mask is not None:
            h = torch.where(mask[..., None], h,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        h = L.conv1d(self.dwconv, h)
        h = L.adain_1d(self.norm, h, s, mask)
        h = L.linear(self.pwconv2, L.gelu(L.linear(self.pwconv1, h)))
        return x + self.gamma.to(h.dtype) * h


class VocosGenerator(nn.Module):
    def __init__(self, cfg: DecoderConfig, style_dim: int = 128,
                 dim: int = 512):
        super().__init__()
        self.n_fft = cfg.gen_istft_n_fft
        self.hop = cfg.gen_istft_hop_size
        # no sine source: nothing is drawn
        self.source_samples_per_frame = 0
        n = cfg.num_layers
        self.convnext = nn.ModuleList(
            [ConvNeXtBlock(dim, cfg.intermediate_dim, 1.0 / n, style_dim)
             for _ in range(n)])
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-6)
        self.stft = nn.ModuleDict({"out": nn.Linear(dim, self.n_fft + 2)})

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                f0_curve: Optional[torch.Tensor] = None,
                frame_mask: Optional[torch.Tensor] = None,
                source=None,
                seq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, C) features at mel rate, s (B, style), frame_mask (B, T)
        bool valid frames or None; the F0 curve and source draws are not
        used (the decoder's generator interface) -> wav (B, T * hop, 1)
        f32. seq_mask: (B, T) in-sequence slots of a sequence-parallel
        window (parallel/seqpar.py): the others add neither audio nor
        window envelope to the overlap-add. Unlike frame_mask's padded
        frames, which do add to it, as on one device."""
        for blk in self.convnext:
            x = blk(x, s, frame_mask)
        ln = self.final_layer_norm
        x = L.plain_layer_norm(x, ln.eps, ln.weight, ln.bias)
        h = L.linear(self.stft["out"], x).float().transpose(1, 2)
        mag, phase = h.chunk(2, dim=1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        wav = OPS.istft_vocos(mag * torch.cos(phase), mag * torch.sin(phase),
                              self.n_fft, self.hop, self.n_fft,
                              frame_valid=seq_mask)
        return wav[..., None]
