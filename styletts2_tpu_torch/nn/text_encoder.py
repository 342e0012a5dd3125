"""TextEncoder: embedding -> depth x (conv, LayerNorm, lrelu) -> BiLSTM.

Counterpart of styletts2_tpu/nn/text_encoder.py (state-dict keys
embedding.weight, cnn.{i}.0.*, cnn.{i}.1.{gamma,beta}, lstm.*).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from styletts2_tpu_torch.nn import layers as L


class TextEncoder(nn.Module):
    def __init__(self, channels: int = 512, kernel_size: int = 5,
                 depth: int = 3, n_symbols: int = 178):
        super().__init__()
        self.embedding = nn.Embedding(n_symbols, channels)
        self.cnn = nn.ModuleList([
            nn.ModuleList([L.wn(nn.Conv1d(channels, channels, kernel_size,
                                          padding=(kernel_size - 1) // 2)),
                           L.LayerNorm(channels)])
            for _ in range(depth)])
        self.lstm = L.bilstm(channels, channels // 2)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens (B, T) int64, mask (B, T) bool -> (B, T, C), zero at
        padded positions. gen: train-mode dropout (0.2) from it."""
        m = mask[..., None]
        zero = torch.zeros((), device=tokens.device)
        x = torch.where(m, self.embedding(tokens), zero)
        for conv, norm in self.cnn:
            x = L.leaky_relu(norm(L.conv1d(conv, x)), 0.2)
            x = torch.where(m, L.dropout(x, 0.2, gen), zero)
        return torch.where(m, L.lstm(self.lstm, x, mask), zero)
