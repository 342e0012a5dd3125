"""NN primitives in PyTorch: channels-last helpers around torch modules.

Counterpart of styletts2_tpu/nn/layers.py. Parameters live in standard
torch modules (nn.Conv1d, nn.ConvTranspose1d, nn.Linear, nn.LSTM, ...)
whose state-dict keys are the reference torch keys the JAX param trees
mirror, with weight norm fused into a plain `weight`. Activations keep the
JAX package's layout at every public function: (B, T, C) for 1-D,
channels-last; masks are "valid" masks (True = real data). The helpers cast
weights to the activation dtype, as the JAX apply functions do, so one
f32 parameter set serves the f32 and the bf16 decoder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake1D: x + (1/a) * sin^2(a*x)."""
    s = torch.sin(alpha * x)
    return x + (1.0 / alpha) * (s * s)


def _cast(p: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, mod.weight.to(x.dtype), _cast(mod.bias, x.dtype))


def conv1d(mod: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) -> (B, T', C_out) with the module's stride, padding,
    dilation and groups."""
    y = F.conv1d(x.transpose(1, 2), mod.weight.to(x.dtype),
                 _cast(mod.bias, x.dtype), mod.stride, mod.padding,
                 mod.dilation, mod.groups)
    return y.transpose(1, 2)


def conv_transpose1d(mod: nn.ConvTranspose1d, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) -> (B, (T-1)*stride - 2*pad + k + output_padding, C_out)."""
    y = F.conv_transpose1d(x.transpose(1, 2), mod.weight.to(x.dtype),
                           _cast(mod.bias, x.dtype), mod.stride, mod.padding,
                           mod.output_padding, mod.groups, mod.dilation)
    return y.transpose(1, 2)


class LayerNorm(nn.Module):
    """Channel LayerNorm with the reference's `gamma`/`beta` names."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., C), normalised over the trailing channel dim in f32."""
        return (_ln_f32(x, self.eps) * self.gamma + self.beta).to(x.dtype)


def _ln_f32(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def plain_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free layer norm over the trailing dim: f32 math, x.dtype out."""
    return _ln_f32(x, eps).to(x.dtype)


def masked_stats(xf: torch.Tensor, m: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass masked mean and biased variance over the T axis of a
    (B, T, C) f32 tensor; m: (B, T, 1) f32 or None."""
    if m is None:
        mean = xf.mean(dim=1, keepdim=True)
        return mean, ((xf - mean) ** 2).mean(dim=1, keepdim=True)
    n = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    mean = (xf * m).sum(dim=1, keepdim=True) / n
    return mean, (torch.square(xf - mean) * m).sum(dim=1, keepdim=True) / n


class AdaIN1d(nn.Module):
    """AdaIN1d: fc style -> (gamma, beta) of 2*C."""

    def __init__(self, style_dim: int, num_features: int):
        super().__init__()
        self.fc = nn.Linear(style_dim, num_features * 2)


def adain_1d_act(mod: AdaIN1d, x: torch.Tensor, s: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, act: str = "none",
                 alpha: Optional[torch.Tensor] = None,
                 slope: float = 0.2) -> torch.Tensor:
    """(1+gamma) * InstanceNorm(x) + beta, then the activation and the
    re-zeroing of padded rows. x: (B, T, C); mask: (B, T) bool."""
    gamma, beta = linear(mod.fc, s).chunk(2, dim=-1)
    xf = x.float()
    m = None if mask is None else mask.to(torch.float32)[..., None]
    mean, var = masked_stats(xf, m)
    y = ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    z = (1.0 + gamma[:, None, :]) * y + beta[:, None, :]
    if act == "snake":
        z = snake(z, alpha.to(z.dtype))
    elif act == "lrelu":
        z = leaky_relu(z, slope)
    if mask is not None:
        z = torch.where(mask[..., None], z, torch.zeros((), dtype=z.dtype,
                                                        device=z.device))
    return z


class AdaLayerNorm(nn.Module):
    """(1+gamma) * LN(x) + beta over channels, gamma/beta from fc(style)."""

    def __init__(self, style_dim: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.fc = nn.Linear(style_dim, channels * 2)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        gamma, beta = linear(self.fc, s).chunk(2, dim=-1)
        y = plain_layer_norm(x, self.eps)
        return (1.0 + gamma[:, None, :]) * y + beta[:, None, :]


def upsample_nearest_1d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, T, C) nearest upsample on T."""
    return torch.repeat_interleave(x, factor, dim=1)


def bilstm(hidden_in: int, hidden: int) -> nn.LSTM:
    return nn.LSTM(hidden_in, hidden, batch_first=True, bidirectional=True)


def lstm(mod: nn.LSTM, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T, In) -> (B, T, 2H) with per-row valid prefix lengths from
    `mask` (B, T): packed sequences, so each direction starts from the zero
    state at its row's own ends, and padded rows come back as zeros — the
    masked-carry semantics of the JAX scan."""
    t = x.shape[1]
    lengths = mask.sum(dim=1).to(device="cpu", dtype=torch.int64)
    packed = pack_padded_sequence(x, torch.clamp(lengths, min=1),
                                  batch_first=True, enforce_sorted=False)
    out, _ = mod(packed)
    out, _ = pad_packed_sequence(out, batch_first=True, total_length=t)
    return torch.where(mask[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
