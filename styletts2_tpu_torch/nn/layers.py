"""NN primitives in PyTorch: channels-last helpers around torch modules.

Counterpart of styletts2_tpu/nn/layers.py. Parameters live in standard
torch modules (nn.Conv1d, nn.ConvTranspose1d, nn.Linear, nn.LSTM, ...)
whose state-dict keys are the reference torch keys the JAX param trees
mirror: weight norm is fused into a plain `weight` for inference and kept
as `weight_g`/`weight_v` in a training build (`wn`, `weight_of`).
Activations keep the
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


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake1D: x + (1/a) * sin^2(a*x)."""
    s = torch.sin(alpha * x)
    return x + (1.0 / alpha) * (s * s)


def _cast(p: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


def wn(mod: nn.Module) -> nn.Module:
    """Mark a conv as weight-normed in the reference (the JAX trees hold
    its `weight_g`/`weight_v`). Inference fuses the pair into `weight` at
    load; a training build splits it back (weights.split_weight_norm)."""
    mod.weight_norm = True
    return mod


def weight_of(mod: nn.Module) -> torch.Tensor:
    """The module's weight: `weight`, or g * v / ||v|| (norm over all but
    dim 0, torch weight_norm(dim=0) parity) when it holds the pair."""
    if "weight_v" in mod._parameters:
        v = mod.weight_v
        norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())),
                                    keepdim=True))
        return mod.weight_g * v / norm
    return mod.weight


def dropout(x: torch.Tensor, p: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a mask drawn from `gen`; the identity when
    `gen` is None (eval, or draws fixed) or p is 0."""
    if gen is None or p <= 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, weight_of(mod).to(x.dtype), _cast(mod.bias, x.dtype))


def conv1d(mod: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) -> (B, T', C_out) with the module's stride, padding,
    dilation and groups."""
    y = F.conv1d(x.transpose(1, 2), weight_of(mod).to(x.dtype),
                 _cast(mod.bias, x.dtype), mod.stride, mod.padding,
                 mod.dilation, mod.groups)
    return y.transpose(1, 2)


def conv2d(mod: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """NCHW conv with the module's geometry and its (possibly weight-normed)
    weight."""
    return F.conv2d(x, weight_of(mod).to(x.dtype), _cast(mod.bias, x.dtype),
                    mod.stride, mod.padding, mod.dilation, mod.groups)


def conv_transpose1d(mod: nn.ConvTranspose1d, x: torch.Tensor) -> torch.Tensor:
    """(B, T, C_in) -> (B, (T-1)*stride - 2*pad + k + output_padding, C_out)."""
    y = F.conv_transpose1d(x.transpose(1, 2), weight_of(mod).to(x.dtype),
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


def group_norm(mod: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """torch GroupNorm on channels-last (B, T, C): statistics over (T, C/G),
    f32 math (styletts2_tpu/nn/layers.py group_norm_apply)."""
    y = F.group_norm(x.transpose(1, 2).float(), mod.num_groups,
                     mod.weight, mod.bias, mod.eps)
    return y.transpose(1, 2).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm parameters under the reference's keys (weight, bias,
    running_mean, running_var; no batch counter)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x: NCHW (or any (B, C, ...)). Eval: the running statistics;
        train: this batch's statistics, with the running ones left as they
        are (the JAX package updates them functionally, and the frozen
        pitch extractor never trains)."""
        if train:
            axes = (0,) + tuple(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dim=axes)
            var = ((xf - mean.view(1, -1, *([1] * (x.dim() - 2)))) ** 2
                   ).mean(dim=axes)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        scale = (self.weight * inv).to(x.dtype)
        shift = (self.bias - self.weight * mean * inv).to(x.dtype)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.view(shape) + shift.view(shape)


def upsample_nearest_1d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B, T, C) nearest upsample on T."""
    return torch.repeat_interleave(x, factor, dim=1)


def bilstm(hidden_in: int, hidden: int) -> nn.LSTM:
    return nn.LSTM(hidden_in, hidden, batch_first=True, bidirectional=True)


def _shift_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """out[b, t] = x[b, t - shift[b]] where 0 <= t - shift[b] < T, else 0;
    shift (B,) int64 on x's device (a gather: no host sync)."""
    t = x.shape[1]
    src = torch.arange(t, device=x.device)[None, :] - shift[:, None]
    inside = (src >= 0) & (src < t)
    idx = torch.clamp(src, 0, t - 1)[..., None].expand(-1, -1, x.shape[2])
    return torch.where(inside[..., None], torch.gather(x, 1, idx),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def lstm(mod: nn.LSTM, x: torch.Tensor,
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, In) -> (B, T, 2H); mask None: every step valid. With per-row
    valid prefix lengths from `mask` (B, T): each direction starts from the zero state at its row's
    own ends, and padded rows come back as zeros — the masked-carry
    semantics of the JAX scan (styletts2_tpu/nn/layers.py lstm_apply).

    No host sync and one shape for every length, so a CUDA graph captures
    it: one bidirectional call runs over 2B rows, the rows as given
    (left-aligned: the forward half is read there, padding only follows
    the valid steps) and the same rows right-aligned (the reverse half is
    read there, padding only follows in reverse order, then gathered back
    to the left). At batch 1 the recurrence is latency-bound, so 2B rows
    cost about what B rows do."""
    if mask is None:
        return mod(x)[0]
    b, t, _ = x.shape
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x = torch.where(mask[..., None], x, zero)
    pad = t - mask.sum(dim=1)
    out, _ = mod(torch.cat([x, _shift_rows(x, pad)], dim=0))
    h = out.shape[2] // 2
    rev = _shift_rows(out[b:, :, h:], -pad)
    out = torch.cat([out[:b, :, :h], rev], dim=-1)
    return torch.where(mask[..., None], out, zero)


def lstm_cell(mod: nn.LSTMCell, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTMCell step in the JAX package's gate order and f32 cell
    (styletts2_tpu/nn/layers.py lstm_cell_apply)."""
    gates = (F.linear(x, mod.weight_ih) + F.linear(h, mod.weight_hh)
             + (mod.bias_ih + mod.bias_hh))
    i, f, g, o = gates.float().chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2.to(x.dtype), c2


def length_to_valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool, True where position < length."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])
