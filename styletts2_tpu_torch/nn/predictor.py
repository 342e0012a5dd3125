"""ProsodyPredictor: DurationEncoder (BiLSTM + AdaLayerNorm stack), the
duration head and the style-conditioned F0/energy heads.

Counterpart of styletts2_tpu/nn/predictor.py (state-dict keys
text_encoder.lstms.{0,2,4} BiLSTMs, text_encoder.lstms.{1,3,5}
AdaLayerNorms, lstm.*, duration_proj.linear_layer.*, shared.*,
F0.{0,1,2}.*, N.{0,1,2}.*, F0_proj.*, N_proj.*). A `gen` argument turns
on train-mode dropout drawn from that generator; None is eval.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from styletts2_tpu_torch.nn import blocks as B
from styletts2_tpu_torch.nn import layers as L


class DurationEncoder(nn.Module):
    def __init__(self, style_dim: int, d_hid: int, nlayers: int):
        super().__init__()
        mods = []
        for _ in range(nlayers):
            mods.append(L.bilstm(d_hid + style_dim, d_hid // 2))
            mods.append(L.AdaLayerNorm(style_dim, d_hid))
        self.lstms = nn.ModuleList(mods)


class DurationProj(nn.Module):
    def __init__(self, d_hid: int, max_dur: int):
        super().__init__()
        self.linear_layer = nn.Linear(d_hid, max_dur)


class ProsodyPredictor(nn.Module):
    def __init__(self, style_dim: int = 128, d_hid: int = 512,
                 nlayers: int = 3, max_dur: int = 50):
        super().__init__()
        self.text_encoder = DurationEncoder(style_dim, d_hid, nlayers)
        self.lstm = L.bilstm(d_hid + style_dim, d_hid // 2)
        self.duration_proj = DurationProj(d_hid, max_dur)
        self.shared = L.bilstm(d_hid + style_dim, d_hid // 2)
        for name in ("F0", "N"):
            setattr(self, name, nn.ModuleList([
                B.AdainResBlk1d(d_hid, d_hid, style_dim),
                B.AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True),
                B.AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim)]))
        self.F0_proj = nn.Conv1d(d_hid // 2, 1, 1)
        self.N_proj = nn.Conv1d(d_hid // 2, 1, 1)

    def encode_duration(self, t_en: torch.Tensor, s: torch.Tensor,
                        mask: torch.Tensor, dropout_p: float = 0.2,
                        gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """t_en (B, T, C), s (B, style), mask (B, T) -> (B, T, C + style)."""
        m = mask[..., None]
        zero = torch.zeros((), dtype=t_en.dtype, device=t_en.device)
        s_seq = s[:, None, :].expand(t_en.shape[0], t_en.shape[1],
                                     s.shape[-1]).to(t_en.dtype)
        x = torch.where(m, torch.cat([t_en, s_seq], dim=-1), zero)
        for i, blk in enumerate(self.text_encoder.lstms):
            if i % 2 == 0:
                x = L.dropout(L.lstm(blk, x, mask), dropout_p, gen)
            else:
                x = torch.cat([blk(x, s), s_seq], dim=-1)
                x = torch.where(m, x, zero)
        return x

    def duration_head(self, d: torch.Tensor, mask: torch.Tensor,
                      gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """d (B, T, C + style) -> duration logits (B, T, max_dur)."""
        x = L.dropout(L.lstm(self.lstm, d, mask), 0.5, gen)
        return L.linear(self.duration_proj.linear_layer, x)

    def forward(self, t_en: torch.Tensor, s: torch.Tensor,
                mask: torch.Tensor, alignment: torch.Tensor,
                dropout_p: float = 0.2,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward (styletts2_tpu/nn/predictor.py forward):
        alignment (B, T, F) -> (duration logits (B, T, max_dur), prosody
        features en (B, F, C + style))."""
        d = self.encode_duration(t_en, s, mask, dropout_p, gen)
        duration = self.duration_head(d, mask, gen)
        return duration, torch.matmul(alignment.transpose(1, 2), d)

    def f0n(self, en: torch.Tensor, s: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            out_mask: Optional[torch.Tensor] = None,
            dropout_p: float = 0.0,
            gen: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """en (B, F, C + style) prosody features -> (F0, N), each (B, 2F).
        mask at rate F, out_mask at rate 2F (F0Ntrain; training passes no
        masks and its dropout)."""
        x = L.lstm(self.shared, en, mask)
        outs = []
        for blocks, proj in ((self.F0, self.F0_proj), (self.N, self.N_proj)):
            h = blocks[0](x, s, mask=mask, dropout_p=dropout_p, gen=gen)
            h = blocks[1](h, s, mask=mask, out_mask=out_mask,
                          dropout_p=dropout_p, gen=gen)
            h = blocks[2](h, s, mask=out_mask, dropout_p=dropout_p, gen=gen)
            outs.append(L.conv1d(proj, h)[..., 0])
        return outs[0], outs[1]
