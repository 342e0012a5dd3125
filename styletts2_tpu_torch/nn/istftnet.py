"""iSTFTNet generator: two upsampling stages, the harmonic source injected
through its STFT, and a matmul iSTFT head.

Counterpart of styletts2_tpu/nn/istftnet.py (reference Modules/istftnet.py
Generator). The NSF source runs at the sample rate (prod(rates) * hop
samples per mel frame); its STFT (center, replicate padding) has one frame
more than the main branch before the last stage, which the reflection pad
of one row at the last stage matches, so the last stage's length is
odd-sized (prod(rates) * T + 1) and its valid prefix one row longer than
the frames give. With a frame mask (inference) every AdaINResBlock1 conv
pair runs through kernel B1 on CUDA (nn/blocks.py), at that odd length
too; without one (training) the plain differentiable route runs.
Channels-last activations.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from styletts2_tpu_torch.config import DecoderConfig
from styletts2_tpu_torch.nn import blocks as B
from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.nn.decoder import SourceDraws, SourceModuleHnNSF
from styletts2_tpu_torch.ops import stft as OPS


class ISTFTNetGenerator(nn.Module):
    def __init__(self, cfg: DecoderConfig, style_dim: int = 128):
        super().__init__()
        self.rates = list(cfg.upsample_rates)
        self.kernel_sizes = list(cfg.resblock_kernel_sizes)
        self.n_fft = cfg.gen_istft_n_fft
        self.hop = cfg.gen_istft_hop_size
        # the sine source's samples per mel frame (its draws' length)
        self.source_samples_per_frame = int(np.prod(self.rates)) * self.hop
        n_up = len(self.rates)
        c0 = cfg.upsample_initial_channel
        n_ch = self.n_fft + 2
        self.m_source = SourceModuleHnNSF()
        ups, noise_convs, noise_res, resblocks = [], [], [], []
        for i, (u, k) in enumerate(zip(self.rates, cfg.upsample_kernel_sizes)):
            c_in, c_cur = c0 // (2 ** i), c0 // (2 ** (i + 1))
            ups.append(L.wn(nn.ConvTranspose1d(c_in, c_cur, k, stride=u,
                                               padding=(k - u) // 2)))
            if i + 1 < n_up:
                stride_f0 = int(np.prod(self.rates[i + 1:]))
                noise_convs.append(nn.Conv1d(n_ch, c_cur, stride_f0 * 2,
                                             stride=stride_f0,
                                             padding=(stride_f0 + 1) // 2))
                noise_res.append(B.AdaINResBlock1(c_cur, 7, (1, 3, 5),
                                                  style_dim))
            else:
                noise_convs.append(nn.Conv1d(n_ch, c_cur, 1))
                noise_res.append(B.AdaINResBlock1(c_cur, 11, (1, 3, 5),
                                                  style_dim))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                resblocks.append(B.AdaINResBlock1(c_cur, rk, tuple(rd),
                                                  style_dim))
        self.ups = nn.ModuleList(ups)
        self.noise_convs = nn.ModuleList(noise_convs)
        self.noise_res = nn.ModuleList(noise_res)
        self.resblocks = nn.ModuleList(resblocks)
        self.conv_post = L.wn(nn.Conv1d(c_cur, n_ch, 7, padding=3))

    def source_features(self, f0_curve: torch.Tensor,
                        source: Optional[SourceDraws] = None) -> torch.Tensor:
        """(B, T) f32 F0 at mel rate -> (B, T * prod(rates) + 1, n_fft + 2)
        f32: the harmonic source's STFT magnitude and phase, with no
        gradient (the reference's source is outside the graph)."""
        up = self.source_samples_per_frame
        f0_up = OPS.interpolate_nearest(f0_curve[:, None, :], up)
        har = self.m_source(f0_up.transpose(1, 2), up, source)[..., 0]
        har = har.detach()
        mag, phase = OPS.stft_mag_phase(har, self.n_fft, self.hop, self.n_fft,
                                        center=True, pad_mode="replicate")
        return torch.cat([mag, phase], dim=1).transpose(1, 2)

    def forward(self, x: torch.Tensor, s: torch.Tensor, f0_curve: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None,
                source: Optional[SourceDraws] = None,
                seq_win: Optional[dict] = None) -> torch.Tensor:
        """x (B, T, C) features at mel rate, s (B, style), f0_curve (B, T)
        f32 at mel rate, frame_mask (B, T) bool valid prefix at mel rate
        (None: the plain route), source: the sine source's draws (None:
        zero phase and noise) -> wav (B, T * prod(rates) * hop, 1) f32.

        seq_win (a sequence-parallel window, parallel/seqpar.py): the
        generator runs on a haloed window of the global sequence, with
        frame_mask its valid interval. A dict of
          'har' (B, T * prod(rates) + 1, n_fft + 2): the window of the
                harmonic source's STFT computed from the whole F0 curve
                (its sine phase and its replicate-padded frames are
                global), the window's +1 tail frame included;
          'pad0' (T * prod(rates) + 1,) bool: the slot holding GLOBAL
                reflection-padded position 0 (rank 0 only): the single
                device prepends x[:, 1:2] to the whole sequence, so the
                window prepends a placeholder edge frame (absorbed by the
                halo margin) and this slot takes the true reflect value;
          'mask_pad' (B, T * prod(rates) + 1): the last stage's validity
                in reflection-padded coordinates;
          'grid' (T * prod(rates) + 1,) bool: the slots inside the global
                padded grid; the others add nothing to the overlap-add (a
                single-device tensor has no such slots).
        The source is not computed here then."""
        rates = self.rates
        n_up = len(rates)
        n_k = len(self.kernel_sizes)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if seq_win is not None:
            har = seq_win["har"].to(x.dtype)
        else:
            har = self.source_features(f0_curve, source).to(x.dtype)
        if frame_mask is not None:
            n_val = frame_mask.sum(dim=1, dtype=torch.int32)

        def prefix(length, nv):
            pos = torch.arange(length, dtype=torch.int32, device=x.device)
            return pos[None, :] < nv[:, None]

        def keep(v, m):
            return v if m is None else torch.where(m[..., None], v, zero)

        m_in = frame_mask
        for i, up in enumerate(self.ups):
            last = i == n_up - 1
            x = keep(L.leaky_relu(x, 0.1), m_in)
            x_source = L.conv1d(self.noise_convs[i], har)
            x = L.conv_transpose1d(up, x)
            if last and seq_win is None:  # ReflectionPad1d((1, 0))
                x = torch.cat([x[:, 1:2], x], dim=1)
            elif last:
                # the pad is global: a placeholder edge frame, then the
                # slot of global padded position 0 takes x[global 1],
                # two slots to its right in the same window
                x = torch.cat([x[:, :1], x], dim=1)
                x = torch.where(seq_win["pad0"][None, :, None],
                                torch.roll(x, -2, dims=1), x)
            m_out = nv_out = None
            rp = int(np.prod(rates[: i + 1]))
            if seq_win is not None:
                # the window's interval (no B1 inside a window)
                m_out = (seq_win["mask_pad"] if last else
                         torch.repeat_interleave(frame_mask, rp, dim=1))
            elif frame_mask is not None:
                # the reflection pad adds one valid row at the front
                nv_out = n_val * rp + int(last)
                m_out = prefix(x.shape[1], nv_out)
            x = x + self.noise_res[i](x_source, s, m_out, nv_out)
            xs = None
            for j in range(n_k):
                r = self.resblocks[i * n_k + j](x, s, m_out, nv_out)
                xs = r if xs is None else xs + r
            x = xs / n_k
            m_in = m_out
        # the bucket-padding rows hold resblock bias and spill, and a
        # window's out-of-grid slots conv bias and spill: zeroed so
        # conv_post and the overlap-add see exact-length semantics
        x = keep(L.leaky_relu(x, 0.01), m_in)
        x = L.conv1d(self.conv_post, x).transpose(1, 2).float()
        half = self.n_fft // 2 + 1
        spec = torch.exp(x[:, :half])
        phase = torch.sin(x[:, half:])
        grid = None if seq_win is None else seq_win["grid"]
        return OPS.istft_conv(spec, phase, self.n_fft, self.hop, self.n_fft,
                              frame_valid=grid).transpose(1, 2)
