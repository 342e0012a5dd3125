"""Alignment: durations -> hard alignment (the inference length regulator),
and the training step's joint length mask and monotonic alignment.

Counterpart of styletts2_tpu/ops/align.py build_alignment, mask_from_lens
and maximum_path.
"""

from __future__ import annotations

import torch


def build_alignment(durations: torch.Tensor, n_frames: int) -> torch.Tensor:
    """durations (B, T) integer frame counts -> (B, T, n_frames) f32 0/1
    with alignment[b, i, t] = 1 iff sum(d[:i]) <= t < sum(d[:i+1])."""
    d = durations.to(torch.float32)
    ends = torch.cumsum(d, dim=1)
    starts = ends - d
    pos = torch.arange(n_frames, dtype=torch.float32,
                       device=durations.device)[None, None, :]
    return ((pos >= starts[..., None]) & (pos < ends[..., None])).to(
        torch.float32)


def mask_from_lens(t_x: torch.Tensor, t_y: torch.Tensor, max_x: int,
                   max_y: int) -> torch.Tensor:
    """(B,) text / mel lengths -> (B, max_x, max_y) bool joint valid mask
    (styletts2_tpu/ops/align.py mask_from_lens)."""
    mx = torch.arange(max_x, device=t_x.device)[None, :, None] < t_x[:, None, None]
    my = torch.arange(max_y, device=t_y.device)[None, None, :] < t_y[:, None, None]
    return mx & my


_NEG = -1e9


@torch.no_grad()
def maximum_path(value: torch.Tensor, t_x: torch.Tensor,
                 t_y: torch.Tensor) -> torch.Tensor:
    """Monotonic max-sum path (styletts2_tpu/ops/align.py maximum_path):
    value (B, X, Y) scores, t_x, t_y (B,) valid extents -> (B, X, Y) 0/1
    f32 path. v[x, y] = value[x, y] + max(v[x, y-1], v[x-1, y-1]) inside
    the monotonic band, then a backtrack from (t_x - 1, t_y - 1). Both
    passes loop over the Y axis on the tensors' device, in the JAX
    package's f32 order, so the path is the same bit for bit; no host
    sync (the reference copies the attention to the host for a Cython
    kernel)."""
    b, max_x, max_y = value.shape
    dev = value.device
    value = value.float()
    x_idx = torch.arange(max_x, device=dev)[None, :]
    tx = t_x.long()[:, None]
    ty = t_y.long()[:, None]
    neg = torch.full((), _NEG, device=dev)
    v_prev = torch.full((b, max_x), _NEG, device=dev)
    first = torch.where(x_idx == 0, torch.zeros((), device=dev), neg)
    cols = []
    for y in range(max_y):
        in_band = (x_idx >= torch.clamp(tx + y - ty, min=0)) & \
            (x_idx < torch.clamp(tx, max=y + 1))
        v_stay = torch.where(x_idx == y, neg, v_prev)
        if y == 0:
            v_shift = first.expand(b, max_x)
        else:
            v_shift = torch.cat([neg.expand(b, 1), v_prev[:, :-1]], dim=1)
        v_col = value[:, :, y] + torch.maximum(v_stay, v_shift)
        v_prev = torch.where(in_band, v_col, neg)
        cols.append(v_prev)
    v_all = torch.stack(cols, dim=2)  # (B, X, Y)

    index = torch.clamp(t_x.long() - 1, min=0)
    path = torch.zeros(b, max_x, max_y, device=dev)
    for y in range(max_y - 1, -1, -1):
        active = y < t_y
        path[:, :, y] = ((x_idx == index[:, None]) & active[:, None]).float()
        col = v_all[:, :, max(y - 1, 0)]
        v_stay = torch.gather(col, 1, index[:, None])[:, 0]
        v_diag = torch.gather(col, 1, torch.clamp(index - 1, min=0)[:, None])[:, 0]
        move = (index != 0) & ((index == y) | (v_stay < v_diag)) & active
        index = torch.where(move, index - 1, index)
    return path
