"""JDC pitch extractor: the CRNN F0 estimator, frozen during training.

Counterpart of styletts2_tpu/nn/jdc.py (reference Modules/JDC/model.py).
State-dict keys mirror the JAX param tree; it runs in NCHW with the mel as
a (time, mel) image, BatchNorm on its running statistics, and is never
trained (no gradient reaches it; the step calls it under no_grad).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from styletts2_tpu_torch.nn import layers as L

_SLOPE = 0.01


def _conv(cin: int, cout: int, k: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=False)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.pre_conv = nn.ModuleDict({"0": L.BatchNorm(cin)})
        self.conv = nn.ModuleDict({"0": _conv(cin, cout),
                                   "1": L.BatchNorm(cout),
                                   "3": _conv(cout, cout)})
        self.conv1by1 = _conv(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F) -> (B, C', T, F // 2)."""
        h = L.leaky_relu(self.pre_conv["0"](x), _SLOPE)
        h = F.max_pool2d(h, (1, 2))
        y = L.leaky_relu(self.conv["1"](self.conv["0"](h)), _SLOPE)
        y = self.conv["3"](y)
        return y + (h if self.conv1by1 is None else self.conv1by1(h))


class JDCNet(nn.Module):
    def __init__(self, num_class: int = 1):
        super().__init__()
        self.conv_block = nn.ModuleDict({"0": _conv(1, 64),
                                         "1": L.BatchNorm(64),
                                         "3": _conv(64, 64)})
        self.res_block1 = ResBlock(64, 128)
        self.res_block2 = ResBlock(128, 192)
        self.res_block3 = ResBlock(192, 256)
        self.pool_block = nn.ModuleDict({"0": L.BatchNorm(256)})
        self.bilstm_classifier = L.bilstm(512, 256)
        self.classifier = nn.Linear(512, num_class)
        # the voicing-detector branch: unused by the forward (reference
        # JDC/model.py:102-137), kept for checkpoint parity
        self.detector_conv = nn.ModuleDict({"0": _conv(640, 256, 1),
                                            "1": L.BatchNorm(256)})
        self.bilstm_detector = L.bilstm(512, 256)
        self.detector = nn.Linear(512, 2)

    def forward(self, mel_norm: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 80, T) normalised log-mel -> (F0 (B, T), GAN feature
        (B, 256, T, 10))."""
        x = mel_norm.transpose(1, 2)[:, None]  # (B, 1, T, 80)
        cb = self.conv_block
        h = cb["3"](L.leaky_relu(cb["1"](cb["0"](x)), _SLOPE))
        h = self.res_block3(self.res_block2(self.res_block1(h)))
        h = L.leaky_relu(self.pool_block["0"](h), _SLOPE)
        gan_feature = h
        h = F.max_pool2d(h, (1, 4))  # (B, 256, T, 2)
        b, _, t, _ = h.shape
        h = h.permute(0, 2, 1, 3).reshape(b, t, 512)
        out = L.linear(self.classifier, L.lstm(self.bilstm_classifier, h, None))
        return torch.abs(out[..., 0]), gan_feature
