"""Style-conditioned decoder shell + HiFi-GAN generator with its NSF source.

Counterpart of styletts2_tpu/nn/decoder.py for the hifigan decoder type at
inference (rng=None: zero sine phase and zero noise, so the output is
deterministic). The generator runs unfolded: every AdaINResBlock1 conv
pair goes through kernel B1 on CUDA (nn/blocks.py), and bucket padding is
handled with per-stage valid-prefix masks. The JAX package's 128-lane time
folding is a TPU layout and is not carried over. Channels-last activations.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from styletts2_tpu_torch.config import DecoderConfig
from styletts2_tpu_torch.nn import blocks as B
from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.ops import stft as OPS


def sine_gen(f0_up: torch.Tensor, upsample_scale: int,
             sampling_rate: int = 24000, harmonic_num: int = 8,
             sine_amp: float = 0.1,
             voiced_threshold: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """SineGen at inference: zero initial phase, zero noise.

    f0_up (B, L, 1) F0 at sample rate -> (sine_waves (B, L, H+1),
    uv (B, L, 1)). The instantaneous frequency is linearly downsampled by
    upsample_scale, integrated, and linearly upsampled back (this shapes
    the harmonic phase exactly as the reference does)."""
    b, length, _ = f0_up.shape
    harmonics = torch.arange(1, harmonic_num + 2, dtype=f0_up.dtype,
                             device=f0_up.device)
    rad = torch.remainder(f0_up * harmonics / sampling_rate, 1.0)
    rad_down = OPS.interpolate_linear(rad.transpose(1, 2),
                                      length // upsample_scale)
    phase = torch.cumsum(rad_down.transpose(1, 2).float(), dim=1) * 2.0 * np.pi
    phase = OPS.interpolate_linear(phase.transpose(1, 2) * float(upsample_scale),
                                   length)
    sines = torch.sin(phase.transpose(1, 2)).to(f0_up.dtype)
    uv = (f0_up > voiced_threshold).to(f0_up.dtype)
    return sines * sine_amp * uv, uv


class SourceModuleHnNSF(nn.Module):
    def __init__(self, harmonic_num: int = 8):
        super().__init__()
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0_up: torch.Tensor, upsample_scale: int) -> torch.Tensor:
        """(B, L, 1) F0 at sample rate -> (B, L, 1) harmonic source."""
        sine_wavs, _ = sine_gen(f0_up, upsample_scale)
        return torch.tanh(L.linear(self.l_linear, sine_wavs))


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: DecoderConfig, style_dim: int = 128):
        super().__init__()
        self.rates = list(cfg.upsample_rates)
        self.kernel_sizes = list(cfg.resblock_kernel_sizes)
        n_up = len(self.rates)
        c0 = cfg.upsample_initial_channel
        self.m_source = SourceModuleHnNSF()
        ups, noise_convs, noise_res, resblocks = [], [], [], []
        alphas = [nn.Parameter(torch.ones(1, c0, 1))]
        for i, (u, k) in enumerate(zip(self.rates, cfg.upsample_kernel_sizes)):
            c_in, c_cur = c0 // (2 ** i), c0 // (2 ** (i + 1))
            ups.append(nn.ConvTranspose1d(c_in, c_cur, k, stride=u,
                                          padding=u // 2 + u % 2,
                                          output_padding=u % 2))
            if i + 1 < n_up:
                stride_f0 = int(np.prod(self.rates[i + 1:]))
                noise_convs.append(nn.Conv1d(1, c_cur, stride_f0 * 2,
                                             stride=stride_f0,
                                             padding=(stride_f0 + 1) // 2))
                noise_res.append(B.AdaINResBlock1(c_cur, 7, (1, 3, 5),
                                                  style_dim))
            else:
                noise_convs.append(nn.Conv1d(1, c_cur, 1))
                noise_res.append(B.AdaINResBlock1(c_cur, 11, (1, 3, 5),
                                                  style_dim))
            alphas.append(nn.Parameter(torch.ones(1, c_cur, 1)))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                resblocks.append(B.AdaINResBlock1(c_cur, rk, tuple(rd),
                                                  style_dim))
        self.ups = nn.ModuleList(ups)
        self.noise_convs = nn.ModuleList(noise_convs)
        self.noise_res = nn.ModuleList(noise_res)
        self.resblocks = nn.ModuleList(resblocks)
        self.alphas = nn.ParameterList(alphas)
        self.conv_post = nn.Conv1d(c_cur, 1, 7, padding=3)

    def forward(self, x: torch.Tensor, s: torch.Tensor, f0_curve: torch.Tensor,
                frame_mask: torch.Tensor) -> torch.Tensor:
        """x (B, T, C) features at mel rate, s (B, style), f0_curve (B, T)
        f32 at mel rate, frame_mask (B, T) bool valid prefix at mel rate ->
        wav (B, T * prod(rates), 1)."""
        rates = self.rates
        n_up = len(rates)
        n_k = len(self.kernel_sizes)
        total_up = int(np.prod(rates))
        t0 = frame_mask.shape[1]
        n_val = frame_mask.sum(dim=1, dtype=torch.int32)

        def stage(i):
            """(valid mask, valid count) at stage i's rate."""
            f = int(np.prod(rates[:i]))
            pos = torch.arange(t0 * f, dtype=torch.int32, device=x.device)
            nv = n_val * f
            return pos[None, :] < nv[:, None], nv

        f0_up = OPS.interpolate_nearest(f0_curve[:, None, :], total_up)
        har = self.m_source(f0_up.transpose(1, 2), total_up)
        sample_mask, _ = stage(n_up)
        har = torch.where(sample_mask[..., None], har,
                          torch.zeros((), device=har.device))

        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        for i, up in enumerate(self.ups):
            m_in, _ = stage(i)
            m_out, nv_out = stage(i + 1)
            x = L.snake(x, self.alphas[i].transpose(1, 2).to(x.dtype))
            x = torch.where(m_in[..., None], x, zero)
            x_source = L.conv1d(self.noise_convs[i], har.to(x.dtype))
            x_source = self.noise_res[i](x_source, s, m_out, nv_out)
            x = L.conv_transpose1d(up, x) + x_source
            xs = None
            for j in range(n_k):
                r = self.resblocks[i * n_k + j](x, s, m_out, nv_out)
                xs = r if xs is None else xs + r
            x = xs / n_k
        x = L.snake(x, self.alphas[n_up].transpose(1, 2).to(x.dtype))
        x = torch.where(sample_mask[..., None], x, zero)
        return torch.tanh(L.conv1d(self.conv_post, x))


class Decoder(nn.Module):
    """Decoder shell: F0/N strided convs, an encode block and four decode
    blocks (the last upsamples 2x), then the HiFi-GAN generator."""

    def __init__(self, cfg: DecoderConfig, dim_in: int = 512,
                 style_dim: int = 128):
        super().__init__()
        if cfg.type != "hifigan":
            raise ValueError(f"decoder type {cfg.type!r} is not ported yet "
                             "(hifigan only)")
        self.encode = B.AdainResBlk1d(dim_in + 2, 1024, style_dim)
        self.decode = nn.ModuleList(
            [B.AdainResBlk1d(1024 + 2 + 64, 1024, style_dim) for _ in range(3)]
            + [B.AdainResBlk1d(1024 + 2 + 64, 512, style_dim, upsample=True)])
        self.F0_conv = nn.Conv1d(1, 1, 3, stride=2, padding=1)
        self.N_conv = nn.Conv1d(1, 1, 3, stride=2, padding=1)
        self.asr_res = nn.ModuleList([nn.Conv1d(dim_in, 64, 1)])
        self.generator = HiFiGANGenerator(cfg, style_dim)

    def prepack(self, dtype: torch.dtype) -> None:
        """Pack every kernel-B1 weight in the decoder dtype."""
        for m in self.modules():
            if isinstance(m, B.AdaINResBlock1):
                m.prepack(dtype)

    def forward(self, asr: torch.Tensor, f0_curve: torch.Tensor,
                n: torch.Tensor, s: torch.Tensor,
                frame_mask: torch.Tensor) -> torch.Tensor:
        """asr (B, F, C) aligned text features at the half-mel rate, in the
        decoder dtype; f0_curve, n (B, 2F) f32 at mel rate; s (B, style) in
        the decoder dtype; frame_mask (B, F) bool valid prefix at the asr
        rate. Returns wav (B, 2F * prod(rates), 1)."""
        mel_mask = torch.repeat_interleave(frame_mask, 2, dim=1)
        zero = torch.zeros((), device=f0_curve.device)
        f0_curve = torch.where(mel_mask, f0_curve, zero)
        n = torch.where(mel_mask, n, zero)
        # the shell runs in asr's dtype: the f32 curves would otherwise
        # promote every 1024-wide shell conv to f32
        f0 = L.conv1d(self.F0_conv, f0_curve[..., None]).to(asr.dtype)
        nn_ = L.conv1d(self.N_conv, n[..., None]).to(asr.dtype)
        x = self.encode(torch.cat([asr, f0, nn_], dim=-1), s, mask=frame_mask)
        asr_res = L.conv1d(self.asr_res[0], asr)
        for blk in self.decode:
            x = torch.cat([x, asr_res, f0, nn_], dim=-1)
            x = blk(x, s, mask=frame_mask,
                    out_mask=mel_mask if blk.upsample else None)
        return self.generator(x, s, f0_curve, mel_mask)
