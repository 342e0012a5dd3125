"""Residual blocks: ResBlk2d (style encoder), AdainResBlk1d (decoder shell
and F0/N heads) and AdaINResBlock1 (the HiFi-GAN and iSTFTNet generators'
dilated Snake/AdaIN stack, every conv pair of which runs through kernel
B1).

Counterpart of styletts2_tpu/nn/blocks.py. Channels-last activations;
module attribute paths are the torch state-dict keys.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.ops import vocoder_kernel as VK

SQRT2 = math.sqrt(2.0)


class ResBlk2d(nn.Module):
    """StyleEncoder ResBlk with learned 'half' downsampling, NCHW.

    Shortcut: 1x1 conv + 2x2 avg-pool (odd W edge-duplicated, odd H
    floored); residual: lrelu, 3x3 conv, depthwise 3x3 stride-2 conv,
    lrelu, 3x3 conv."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim_in, dim_in, 3, padding=1)
        self.conv2 = nn.Conv2d(dim_in, dim_out, 3, padding=1)
        self.downsample_res = nn.ModuleDict({"conv": nn.Conv2d(
            dim_in, dim_in, 3, stride=2, padding=1, groups=dim_in)})
        if dim_in != dim_out:
            self.conv1x1 = nn.Conv2d(dim_in, dim_out, 1, bias=False)
        else:
            self.conv1x1 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = x if self.conv1x1 is None else self.conv1x1(x)
        if sc.shape[3] % 2 != 0:
            sc = torch.cat([sc, sc[..., -1:]], dim=3)
        sc = F.avg_pool2d(sc, 2)
        h = self.conv1(L.leaky_relu(x))
        h = self.downsample_res["conv"](h)
        h = self.conv2(L.leaky_relu(h))
        return (sc + h) / SQRT2


class AdainResBlk1d(nn.Module):
    """AdaIN residual block with optional 2x upsampling (depthwise
    transposed conv k3 s2 p1 op1 on the residual, nearest on the shortcut)."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int = 64,
                 upsample: bool = False):
        super().__init__()
        self.upsample = upsample
        self.conv1 = L.wn(nn.Conv1d(dim_in, dim_out, 3, padding=1))
        self.conv2 = L.wn(nn.Conv1d(dim_out, dim_out, 3, padding=1))
        self.norm1 = L.AdaIN1d(style_dim, dim_in)
        self.norm2 = L.AdaIN1d(style_dim, dim_out)
        self.conv1x1 = (L.wn(nn.Conv1d(dim_in, dim_out, 1, bias=False))
                        if dim_in != dim_out else None)
        self.pool = (L.wn(nn.ConvTranspose1d(dim_in, dim_in, 3, stride=2,
                                             padding=1, output_padding=1,
                                             groups=dim_in))
                     if upsample else None)

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                out_mask: Optional[torch.Tensor] = None,
                dropout_p: float = 0.0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, T, C); mask (B, T) at the input rate; out_mask (B, 2T) at
        the output rate when upsampling. gen: train-mode dropout of
        `dropout_p` after each AdaIN (None: eval)."""
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        sc = x
        if self.upsample:
            sc = L.upsample_nearest_1d(sc, 2)
        if self.conv1x1 is not None:
            if out_mask is not None and self.upsample:
                sc = torch.where(out_mask[..., None], sc, zero)
            sc = L.conv1d(self.conv1x1, sc)
        h = L.adain_1d_act(self.norm1, x, s, mask, act="lrelu")
        cur_mask = mask
        if self.upsample:
            h = L.conv_transpose1d(self.pool, h)
            cur_mask = out_mask
        h = L.dropout(h, dropout_p, gen)
        if self.upsample and cur_mask is not None:
            # the pool conv's bias re-populates the padded rows
            h = torch.where(cur_mask[..., None], h, zero)
        h = L.conv1d(self.conv1, h)
        h = L.adain_1d_act(self.norm2, h, s, cur_mask, act="lrelu")
        h = L.dropout(h, dropout_p, gen)
        h = L.conv1d(self.conv2, h)
        return (h + sc) / SQRT2


def adain_affine(mod: L.AdaIN1d, x: torch.Tensor, s: torch.Tensor,
                 mask: torch.Tensor):
    """AdaIN collapsed into per-(batch, channel) f32 scale/shift from
    two-pass masked statistics of x: (1+gamma)*IN(x)+beta ==
    x*scale + shift."""
    gamma, beta = L.linear(mod.fc, s.float()).chunk(2, dim=-1)
    m = mask.to(torch.float32)[..., None]
    mean, var = L.masked_stats(x.float(), m)
    scale = (1.0 + gamma) * torch.rsqrt(var[:, 0] + 1e-5)
    return scale, beta - mean[:, 0] * scale


def affine_from_stats(mod: L.AdaIN1d, stats: torch.Tensor, s: torch.Tensor,
                      n_valid: torch.Tensor):
    """AdaIN scale/shift from kernel B1's (B, 2, C) [sum, sum of squares]:
    one-pass variance E[x^2] - mean^2, so the bf16 path only (the f32 path
    keeps the two-pass adain_affine)."""
    gamma, beta = L.linear(mod.fc, s.float()).chunk(2, dim=-1)
    n = torch.clamp(n_valid.float(), min=1.0)[:, None]
    mean = stats[:, 0] / n
    var = torch.clamp(stats[:, 1] / n - mean * mean, min=0.0)
    scale = (1.0 + gamma) * torch.rsqrt(var + 1e-5)
    return scale, beta - mean * scale


class AdaINResBlock1(nn.Module):
    """HiFi-GAN AdaINResBlock1: per dilation d,
    x += conv2(snake(adain2(conv1_d(snake(adain1(x)))))). With a valid
    prefix and fused weights (inference) every AdaIN+Snake+conv pair is
    one kernel-B1 call; with weight norm split (a training build) or
    without a prefix the plain differentiable formulation runs."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), style_dim: int = 64):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        n = len(self.dilation)

        def conv(d):
            return L.wn(nn.Conv1d(channels, channels, kernel_size,
                                  dilation=d,
                                  padding=d * (kernel_size - 1) // 2))

        self.convs1 = nn.ModuleList([conv(d) for d in self.dilation])
        self.convs2 = nn.ModuleList([conv(1) for _ in range(n)])
        self.adain1 = nn.ModuleList([L.AdaIN1d(style_dim, channels)
                                     for _ in range(n)])
        self.adain2 = nn.ModuleList([L.AdaIN1d(style_dim, channels)
                                     for _ in range(n)])
        self.alpha1 = nn.ParameterList([nn.Parameter(torch.ones(1, channels, 1))
                                        for _ in range(n)])
        self.alpha2 = nn.ParameterList([nn.Parameter(torch.ones(1, channels, 1))
                                        for _ in range(n)])
        self.packed1 = []
        self.packed2 = []

    def prepack(self, dtype: torch.dtype) -> None:
        """Pack every conv weight as kernel B1 takes it: (k, C_in, C_out)
        in the decoder dtype, contiguous. Non-persistent buffers, so they
        follow the module's .to(device) and stay out of the state dict."""
        for name, convs in (("packed1", self.convs1), ("packed2", self.convs2)):
            names = []
            for i, c in enumerate(convs):
                buf = f"{name}_{i}"
                self.register_buffer(
                    buf, c.weight.detach().permute(2, 1, 0).to(dtype)
                    .contiguous(), persistent=False)
                names.append(buf)
            setattr(self, name, names)

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, T, C) f32 or bf16; mask: (B, T) bool valid prefix;
        n_valid: (B,) int32 prefix lengths. Given both (inference), kernel
        B1: bf16 fuses the residual add into conv2 and takes the next
        AdaIN's statistics from the kernel's partial sums; f32 keeps
        two-pass statistics and a separate add. Without n_valid (the D/G
        step's synthesis, as JAX passes none there), or with weight norm
        split (the SLM round's masked synthesis under autograd: JAX gates
        its kernel on the fused weight): the plain formulation, AdaIN
        statistics over the mask's valid rows when a mask is given, which
        autograd differentiates and which never calls B1. Inside a
        sequence-parallel window (layers.seqpar_ctx) the plain masked route
        too, as in JAX: the window's mask is an interval, not the valid
        prefix B1 zeroes past, and its statistics are global (all-reduced),
        not the kernel's prefix partial sums."""
        if (n_valid is None or "weight_v" in self.convs1[0]._parameters
                or L.seqpar_ctx() is not None):
            return self._plain(x, s, mask)
        if not self.packed1:
            raise RuntimeError("AdaINResBlock1.prepack() was not called")
        x = x.contiguous()  # kernel B1 takes dense (B, T, C)
        fuse = x.dtype == torch.bfloat16
        st = None
        last_i = len(self.dilation) - 1
        for i, d in enumerate(self.dilation):
            w1 = getattr(self, self.packed1[i])
            w2 = getattr(self, self.packed2[i])
            a1 = self.alpha1[i].reshape(-1)
            a2 = self.alpha2[i].reshape(-1)
            b1 = self.convs1[i].bias
            b2 = self.convs2[i].bias
            if st is None:
                sc1, sh1 = adain_affine(self.adain1[i], x, s, mask)
            else:
                sc1, sh1 = affine_from_stats(self.adain1[i], st, s, n_valid)
            if fuse:
                xt, st_x = VK.ada_snake_conv(x, sc1, sh1, a1, w1, b1, d,
                                             n_valid, out_stats=True)
                sc2, sh2 = affine_from_stats(self.adain2[i], st_x, s, n_valid)
                out = VK.ada_snake_conv(xt, sc2, sh2, a2, w2, b2, 1, n_valid,
                                        residual=x, out_stats=i != last_i)
                x, st = (out, None) if i == last_i else out
            else:
                xt = VK.ada_snake_conv(x, sc1, sh1, a1, w1, b1, d, n_valid)
                sc2, sh2 = adain_affine(self.adain2[i], xt, s, mask)
                xt = VK.ada_snake_conv(xt, sc2, sh2, a2, w2, b2, 1, n_valid)
                x = xt + x
        return x

    def _plain(self, x: torch.Tensor, s: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """AdaIN statistics over the valid rows of `mask` (all rows when
        None), each conv's input re-zeroed past them, and plain convs
        (styletts2_tpu/nn/blocks.py adain_res_block1_apply's XLA branch)."""
        for i in range(len(self.dilation)):
            xt = L.adain_1d_act(self.adain1[i], x, s, mask, act="snake",
                                alpha=self.alpha1[i].reshape(-1))
            xt = L.conv1d(self.convs1[i], xt)
            xt = L.adain_1d_act(self.adain2[i], xt, s, mask, act="snake",
                                alpha=self.alpha2[i].reshape(-1))
            x = L.conv1d(self.convs2[i], xt) + x
        return x
