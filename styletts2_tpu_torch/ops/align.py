"""Durations -> hard alignment (the inference length regulator).

Counterpart of styletts2_tpu/ops/align.py build_alignment.
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
