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

import threading
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


# --- per-row random draws under data parallelism ---------------------------
#
# A data-parallel rank holds rows [rank * b, (rank + 1) * b) of the global
# batch. While a `row_draws` context is active, every per-row draw
# (dropout masks, the aligner's unk masking, the crop starts, the sine
# source's phase and noise) is made at the global batch's shape from the
# generator every rank holds in the same state, and this rank keeps its
# rows: the ranks' masks differ as the rows do, the batch-level draws (the
# soft/mono coin) agree, every generator stays in step, and N ranks draw
# what one rank draws for the global batch. That needs every rank's
# tensors in one shape (the data-parallel step pads the texts to the
# ranks' widest first: parallel.pad_to_widest).

_ROWS_TLS = threading.local()


class row_draws:
    """Context manager: per-row draws of the enclosed calls are this rank's
    rows of a draw over every rank's rows (thread-local); mesh: the
    data-parallel ranks (parallel.Mesh), or None for one process."""

    def __init__(self, mesh):
        self.rows = None if mesh is None else (mesh.rank, mesh.size)

    def __enter__(self):
        self._prev = getattr(_ROWS_TLS, "rows", None)
        _ROWS_TLS.rows = self.rows
        return self

    def __exit__(self, *exc):
        _ROWS_TLS.rows = self._prev
        return False


def rand_rows(shape, gen: Optional[torch.Generator], device=None,
              normal: bool = False) -> torch.Tensor:
    """torch.rand (normal: torch.randn) of `shape`, whose leading axis is
    the batch, from `gen`; under `row_draws` this rank's rows of the draw
    at the global batch."""
    draw = torch.randn if normal else torch.rand
    rows = getattr(_ROWS_TLS, "rows", None)
    if rows is None or rows[1] == 1:
        return draw(tuple(shape), generator=gen, device=device)
    rank, size = rows
    b = shape[0]
    full = draw((b * size,) + tuple(shape[1:]), generator=gen, device=device)
    return full[rank * b: (rank + 1) * b]


def dropout(x: torch.Tensor, p: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with a mask drawn from `gen` (per row, see
    `rand_rows`); the identity when `gen` is None (eval, or draws fixed)
    or p is 0."""
    if gen is None or p <= 0.0:
        return x
    keep = 1.0 - p
    mask = rand_rows(x.shape, gen, x.device) < keep
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


def plain_layer_norm(x: torch.Tensor, eps: float = 1e-5,
                     weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer norm over the trailing dim, affine when weight / bias are
    given: f32 math, x.dtype out."""
    y = _ln_f32(x, eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, jax.nn.gelu(approximate=False) parity."""
    return F.gelu(x, approximate="none")


# --- sequence-parallel instance-norm statistics ----------------------------
#
# Inside a frame-sharded decode (parallel/seqpar.py) each rank holds a
# haloed window [core +- margin] of the time axis, but the AdaIN instance
# norms need statistics over the whole sequence. While a SeqParCtx is
# active, every time-axis mean and variance here is taken over the rank's
# CORE region only (the halo is other ranks' core data and must not count
# twice) and all-reduced over the mesh. The context carries the window
# geometry at the base (asr-frame) rate; a stage tensor is an integer
# upsample of it, so the core interval scales with T.


class SeqParCtx:
    """mesh: the ranks to all-reduce over (parallel.mesh.Mesh); t_base: the
    local window length at the base rate; [lo, hi): the core interval at
    the base rate."""

    __slots__ = ("mesh", "t_base", "lo", "hi")

    def __init__(self, mesh, t_base: int, lo: int, hi: int):
        self.mesh, self.t_base, self.lo, self.hi = mesh, t_base, lo, hi


# thread-local, so a seq-par decode on one thread cannot leak its context
# into a plain decode on another (the engine's background capture thread)
_SEQPAR_TLS = threading.local()


def seqpar_ctx() -> Optional[SeqParCtx]:
    return getattr(_SEQPAR_TLS, "ctx", None)


class seqpar_stats:
    """Context manager installing a SeqParCtx for the enclosed calls."""

    def __init__(self, ctx: SeqParCtx):
        self.ctx = ctx

    def __enter__(self):
        self._prev = seqpar_ctx()
        _SEQPAR_TLS.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        _SEQPAR_TLS.ctx = self._prev
        return False


def _seqpar_core_mask(t_local: int, device) -> torch.Tensor:
    """(1, t_local, 1) f32 mask of this rank's core region at the rate
    t_local implies relative to the context's base length.

    rem == 1 is the reflection-padded grid (iSTFTNet's last stage prepends
    ONE frame to the whole sequence): the global grid has f * T_base + 1
    slots, each window carries one extra leading slot, and the standard
    [lo * f, hi * f) core still tiles the grid except for the one extra
    global tail slot, which the LAST rank claims."""
    ctx = seqpar_ctx()
    f, rem = divmod(t_local, ctx.t_base)
    if rem not in (0, 1):
        raise ValueError(
            f"seq-par stats on T={t_local} not a multiple (or multiple+1, "
            f"the reflection-padded grid) of the base window {ctx.t_base}")
    pos = torch.arange(t_local, device=device)
    core = (pos >= ctx.lo * f) & (pos < ctx.hi * f)
    if rem == 1 and ctx.mesh.rank == ctx.mesh.size - 1:
        core = core | (pos == ctx.hi * f)
    return core.to(torch.float32)[None, :, None]


def masked_stats(xf: torch.Tensor, m: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass masked mean and biased variance over the T axis of a
    (B, T, C) f32 tensor; m: (B, T, 1) f32 or None. Under a SeqParCtx the
    statistics are global: the (sum, count) of the core regions are
    all-reduced, then the centred sum of squares (two passes, as on one
    device)."""
    ctx = seqpar_ctx()
    if ctx is not None:
        core = _seqpar_core_mask(xf.shape[1], xf.device)
        m = core if m is None else m * core
    if m is None:
        mean = xf.mean(dim=1, keepdim=True)
        return mean, ((xf - mean) ** 2).mean(dim=1, keepdim=True)
    if ctx is None:
        n = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        mean = (xf * m).sum(dim=1, keepdim=True) / n
        return mean, (torch.square(xf - mean) * m).sum(dim=1,
                                                      keepdim=True) / n
    c = xf.shape[2]
    sn = torch.cat([(xf * m).sum(dim=1, keepdim=True),
                    m.sum(dim=1, keepdim=True).expand(xf.shape[0], 1, 1)],
                   dim=-1)
    ctx.mesh.all_reduce(sn)
    n = torch.clamp(sn[..., c:], min=1.0)
    mean = sn[..., :c] / n
    v = (torch.square(xf - mean) * m).sum(dim=1, keepdim=True)
    ctx.mesh.all_reduce(v)
    return mean, v / n


class AdaIN1d(nn.Module):
    """AdaIN1d: fc style -> (gamma, beta) of 2*C."""

    def __init__(self, style_dim: int, num_features: int):
        super().__init__()
        self.fc = nn.Linear(style_dim, num_features * 2)


def adain_1d(mod: AdaIN1d, x: torch.Tensor, s: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1+gamma) * InstanceNorm(x) + beta with statistics over the valid
    rows; padded rows are not re-zeroed. x: (B, T, C); mask: (B, T)."""
    gamma, beta = linear(mod.fc, s).chunk(2, dim=-1)
    xf = x.float()
    m = None if mask is None else mask.to(torch.float32)[..., None]
    mean, var = masked_stats(xf, m)
    y = ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    return (1.0 + gamma[:, None, :]) * y + beta[:, None, :]


def adain_1d_act(mod: AdaIN1d, x: torch.Tensor, s: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, act: str = "none",
                 alpha: Optional[torch.Tensor] = None,
                 slope: float = 0.2) -> torch.Tensor:
    """adain_1d, then the activation and the re-zeroing of padded rows."""
    z = adain_1d(mod, x, s, mask)
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
