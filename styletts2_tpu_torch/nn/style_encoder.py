"""StyleEncoder: mel -> conv -> 4 x ResBlk('half') -> conv5x5 -> GAP -> linear.

Counterpart of styletts2_tpu/nn/style_encoder.py (state-dict keys
shared.{0,1..4,6}.*, unshared.*). Runs in NCHW with the mel as a
one-channel image.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from styletts2_tpu_torch.nn import blocks as B
from styletts2_tpu_torch.nn import layers as L


class StyleEncoder(nn.Module):
    def __init__(self, dim_in: int = 64, style_dim: int = 128,
                 max_conv_dim: int = 512):
        super().__init__()
        shared = {"0": nn.Conv2d(1, dim_in, 3, padding=1)}
        d = dim_in
        for i in range(4):
            d_out = min(d * 2, max_conv_dim)
            shared[str(1 + i)] = B.ResBlk2d(d, d_out)
            d = d_out
        shared["6"] = nn.Conv2d(d, d, 5)
        self.shared = nn.ModuleDict(shared)
        self.unshared = nn.Linear(max_conv_dim, style_dim)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, n_mels, T) normalised log-mel, T >= 66 frames -> style
        (B, style_dim)."""
        x = self.shared["0"](mel[:, None])
        for i in range(4):
            x = self.shared[str(1 + i)](x)
        x = self.shared["6"](L.leaky_relu(x))
        x = L.leaky_relu(x.mean(dim=(2, 3)))
        return self.unshared(x)
