"""Style-conditioned decoder shell + the generators: HiFi-GAN with its NSF
source (here), iSTFTNet (nn/istftnet.py) and Vocos (nn/vocos.py).

Counterpart of styletts2_tpu/nn/decoder.py: one shell dispatching on the
config's decoder type. Inference (a frame mask given, no source draws:
zero sine phase and zero noise, so the output is deterministic) runs the
generator with per-stage valid-interval masks (a prefix under bucketed
inference, an interior window on the edge ranks of a sequence-parallel
decode, parallel/seqpar.py), every AdaINResBlock1 conv pair of HiFi-GAN
and iSTFTNet through kernel B1 on CUDA outside such windows
(nn/blocks.py).
The D/G step (no frame mask, as JAX's step passes none) runs the plain
differentiable formulation over the whole crop, with the sine source's
random phase and noise passed in (`draw_source`; each generator's
`source_samples_per_frame` sizes them, 0 for Vocos, which has no
source). The SLM round passes a frame mask to a training build (weight
norm split): the same per-stage masks, the plain formulation with masked
AdaIN statistics, differentiable, no B1. The JAX package's 128-lane time
folding is a TPU layout and is not carried over. Channels-last
activations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from styletts2_tpu_torch.config import DecoderConfig
from styletts2_tpu_torch.nn import blocks as B
from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.ops import stft as OPS


SourceDraws = Tuple[torch.Tensor, torch.Tensor]


def draw_source(gen: torch.Generator, b: int, length: int,
                harmonic_num: int = 8, device=None) -> SourceDraws:
    """The sine source's random draws, with the JAX package's distributions:
    initial phases U[0, 1) (B, H+1) with the fundamental's at 0, and unit
    normal noise (B, length, H+1); per row (layers.rand_rows)."""
    dim = harmonic_num + 1
    rand_ini = L.rand_rows((b, dim), gen, device)
    rand_ini[:, 0] = 0.0
    noise = L.rand_rows((b, length, dim), gen, device, normal=True)
    return rand_ini, noise


def sine_gen(f0_up: torch.Tensor, upsample_scale: int,
             source: Optional[SourceDraws] = None,
             sampling_rate: int = 24000, harmonic_num: int = 8,
             sine_amp: float = 0.1, noise_std: float = 0.003,
             voiced_threshold: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """SineGen. source None: zero initial phase and zero noise (inference);
    else (rand_ini, noise) from `draw_source`.

    f0_up (B, L, 1) F0 at sample rate -> (sine_waves (B, L, H+1),
    uv (B, L, 1)). The instantaneous frequency is linearly downsampled by
    upsample_scale, integrated, and linearly upsampled back (this shapes
    the harmonic phase exactly as the reference does)."""
    b, length, _ = f0_up.shape
    harmonics = torch.arange(1, harmonic_num + 2, dtype=f0_up.dtype,
                             device=f0_up.device)
    rad = torch.remainder(f0_up * harmonics / sampling_rate, 1.0)
    if source is not None:
        rad = torch.cat([rad[:, :1] + source[0][:, None, :].to(rad.dtype),
                         rad[:, 1:]], dim=1)
    rad_down = OPS.interpolate_linear(rad.transpose(1, 2),
                                      length // upsample_scale)
    phase = torch.cumsum(rad_down.transpose(1, 2).float(), dim=1) * 2.0 * np.pi
    phase = OPS.interpolate_linear(phase.transpose(1, 2) * float(upsample_scale),
                                   length)
    sines = torch.sin(phase.transpose(1, 2)).to(f0_up.dtype)
    uv = (f0_up > voiced_threshold).to(f0_up.dtype)
    sine_waves = sines * sine_amp * uv
    if source is not None:
        noise_amp = uv * noise_std + (1.0 - uv) * sine_amp / 3.0
        sine_waves = sine_waves + noise_amp * source[1].to(sines.dtype)
    return sine_waves, uv


class SourceModuleHnNSF(nn.Module):
    def __init__(self, harmonic_num: int = 8):
        super().__init__()
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, f0_up: torch.Tensor, upsample_scale: int,
                source: Optional[SourceDraws] = None) -> torch.Tensor:
        """(B, L, 1) F0 at sample rate -> (B, L, 1) harmonic source. No
        gradient flows into the sine bank (the reference's no_grad)."""
        sine_wavs, _ = sine_gen(f0_up, upsample_scale, source)
        return torch.tanh(L.linear(self.l_linear, sine_wavs.detach()))


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: DecoderConfig, style_dim: int = 128):
        super().__init__()
        self.rates = list(cfg.upsample_rates)
        self.kernel_sizes = list(cfg.resblock_kernel_sizes)
        # the sine source's samples per mel frame (its draws' length)
        self.source_samples_per_frame = int(np.prod(self.rates))
        n_up = len(self.rates)
        c0 = cfg.upsample_initial_channel
        self.m_source = SourceModuleHnNSF()
        ups, noise_convs, noise_res, resblocks = [], [], [], []
        alphas = [nn.Parameter(torch.ones(1, c0, 1))]
        for i, (u, k) in enumerate(zip(self.rates, cfg.upsample_kernel_sizes)):
            c_in, c_cur = c0 // (2 ** i), c0 // (2 ** (i + 1))
            ups.append(L.wn(nn.ConvTranspose1d(c_in, c_cur, k, stride=u,
                                               padding=u // 2 + u % 2,
                                               output_padding=u % 2)))
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
        self.conv_post = L.wn(nn.Conv1d(c_cur, 1, 7, padding=3))

    def forward(self, x: torch.Tensor, s: torch.Tensor, f0_curve: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None,
                source: Optional[SourceDraws] = None,
                har_source: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, C) features at mel rate, s (B, style), f0_curve (B, T)
        f32 at mel rate, frame_mask (B, T) bool valid interval at mel rate
        (None: every frame valid, the plain route) -> wav
        (B, T * prod(rates), 1).

        The valid region is a prefix under bucketed inference and an
        interior window on the edge ranks of a sequence-parallel decode
        (parallel/seqpar.py), so the stage masks are intervals from the
        first valid index; the valid count B1 takes is a prefix length (B1
        is gated off inside a seq-par window). har_source: the NSF source
        (B, T * prod(rates), 1) computed by the caller (the seq-par decode
        computes it from the whole F0 curve, whose sine phase is a global
        cumsum, and passes this window's slice); None: from f0_curve."""
        rates = self.rates
        n_up = len(rates)
        n_k = len(self.kernel_sizes)
        total_up = int(np.prod(rates))
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if frame_mask is not None:
            n_val = frame_mask.sum(dim=1, dtype=torch.int32)
            lo_val = frame_mask.to(torch.int32).argmax(dim=1).to(torch.int32)

        def stage(i):
            """(valid mask, valid count) at stage i's rate."""
            if frame_mask is None:
                return None, None
            f = int(np.prod(rates[:i]))
            pos = torch.arange(frame_mask.shape[1] * f, dtype=torch.int32,
                               device=x.device)[None, :]
            nv = n_val * f
            lo = (lo_val * f)[:, None]
            return (pos >= lo) & (pos < lo + nv[:, None]), nv

        def keep(v, m):
            return v if m is None else torch.where(m[..., None], v, zero)

        if har_source is None:
            f0_up = OPS.interpolate_nearest(f0_curve[:, None, :], total_up)
            har = self.m_source(f0_up.transpose(1, 2), total_up, source)
        else:
            har = har_source
        sample_mask, _ = stage(n_up)
        har = keep(har, sample_mask)

        for i, up in enumerate(self.ups):
            m_in, _ = stage(i)
            m_out, nv_out = stage(i + 1)
            x = L.snake(x, self.alphas[i].transpose(1, 2).to(x.dtype))
            x = keep(x, m_in)
            x_source = L.conv1d(self.noise_convs[i], har.to(x.dtype))
            x_source = self.noise_res[i](x_source, s, m_out, nv_out)
            x = L.conv_transpose1d(up, x) + x_source
            xs = None
            for j in range(n_k):
                r = self.resblocks[i * n_k + j](x, s, m_out, nv_out)
                xs = r if xs is None else xs + r
            x = xs / n_k
        x = L.snake(x, self.alphas[n_up].transpose(1, 2).to(x.dtype))
        return torch.tanh(L.conv1d(self.conv_post, keep(x, sample_mask)))


def smooth_f0n(f0_curve: torch.Tensor, n: torch.Tensor, f_width: int,
               n_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centred box filters with zero padding over (B, T) curves, width 1 =
    unchanged (styletts2_tpu/nn/decoder.py smooth_f0n_train's branches; the
    training step, like JAX's, runs the decoder unsmoothed)."""
    def box(x, w):
        if w == 1:
            return x
        kern = torch.ones(1, 1, w, dtype=x.dtype, device=x.device)
        return torch.nn.functional.conv1d(x[:, None], kern,
                                          padding=w // 2)[:, 0] / w

    return box(f0_curve, f_width), box(n, n_width)


class Decoder(nn.Module):
    """Decoder shell: F0/N strided convs, an encode block and four decode
    blocks (the last upsamples 2x), then the generator of `cfg.type`:
    hifigan, istftnet or vocos."""

    def __init__(self, cfg: DecoderConfig, dim_in: int = 512,
                 style_dim: int = 128):
        super().__init__()
        if cfg.type == "hifigan":
            generator = HiFiGANGenerator(cfg, style_dim)
        elif cfg.type == "istftnet":
            from styletts2_tpu_torch.nn.istftnet import ISTFTNetGenerator
            generator = ISTFTNetGenerator(cfg, style_dim)
        elif cfg.type == "vocos":
            from styletts2_tpu_torch.nn.vocos import VocosGenerator
            generator = VocosGenerator(cfg, style_dim)
        else:
            raise ValueError(f"unknown decoder type {cfg.type!r}")
        self.encode = B.AdainResBlk1d(dim_in + 2, 1024, style_dim)
        self.decode = nn.ModuleList(
            [B.AdainResBlk1d(1024 + 2 + 64, 1024, style_dim) for _ in range(3)]
            + [B.AdainResBlk1d(1024 + 2 + 64, 512, style_dim, upsample=True)])
        self.F0_conv = L.wn(nn.Conv1d(1, 1, 3, stride=2, padding=1))
        self.N_conv = L.wn(nn.Conv1d(1, 1, 3, stride=2, padding=1))
        self.asr_res = nn.ModuleList([L.wn(nn.Conv1d(dim_in, 64, 1))])
        self.generator = generator
        self.cfg = cfg

    def prepack(self, dtype: torch.dtype) -> None:
        """Pack every kernel-B1 weight in the decoder dtype."""
        for m in self.modules():
            if isinstance(m, B.AdaINResBlock1):
                m.prepack(dtype)

    def forward(self, asr: torch.Tensor, f0_curve: torch.Tensor,
                n: torch.Tensor, s: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None,
                source: Optional[SourceDraws] = None,
                har_source: Optional[torch.Tensor] = None,
                seq_mask: Optional[torch.Tensor] = None,
                seq_win: Optional[dict] = None) -> torch.Tensor:
        """asr (B, F, C) aligned text features at the half-mel rate, in the
        decoder dtype; f0_curve, n (B, 2F) f32 at mel rate; s (B, style) in
        the decoder dtype; frame_mask (B, F) bool valid prefix at the asr
        rate (kernel B1 with fused weights; the masked plain route with
        weight norm split), or None (the D/G step: every frame valid, no
        kernel B1); source: the sine source's draws (None: zero phase and
        noise). Returns wav
        (B, 2F * the generator's samples per mel frame, 1).

        A sequence-parallel window (parallel/seqpar.py) passes its valid
        interval as frame_mask and one of: har_source (HiFi-GAN: the NSF
        source's slice), seq_mask (Vocos: (B, F) in-sequence slots at the
        asr rate, the iSTFT overlap-add's global grid) or seq_win
        (iSTFTNet: the window descriptor, ISTFTNetGenerator.forward)."""
        t = self.cfg.type
        if t != "hifigan" and har_source is not None:
            raise ValueError("har_source passthrough is hifigan-only")
        if t != "vocos" and seq_mask is not None:
            raise ValueError("seq_mask passthrough is vocos-only")
        if t != "istftnet" and seq_win is not None:
            raise ValueError("seq_win passthrough is istftnet-only")
        mel_mask = None
        if frame_mask is not None:
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
        if t == "hifigan":
            return self.generator(x, s, f0_curve, mel_mask, source,
                                  har_source=har_source)
        if t == "istftnet":
            return self.generator(x, s, f0_curve, mel_mask, source,
                                  seq_win=seq_win)
        if seq_mask is not None:
            seq_mask = torch.repeat_interleave(seq_mask, 2, dim=1)
        return self.generator(x, s, f0_curve, mel_mask, source,
                              seq_mask=seq_mask)
