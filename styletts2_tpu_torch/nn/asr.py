"""ASR text aligner: MFCC -> dilated conv stack -> CTC head + attention
seq2seq decoder (gives the training step its text/mel alignment).

Counterpart of styletts2_tpu/nn/asr.py (reference Modules/ASR/models.py
ASRCNN, ASRS2S and Modules/ASR/layers.py). State-dict keys mirror the JAX
param tree. The JAX package runs the teacher-forced decoder as a
`lax.scan`; here it is a loop of LSTMCell steps on the device (T_text + 1
steps, no host sync). Channels-last activations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.ops import stft as OPS


class ConvNorm(nn.Module):
    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, k, stride=stride, padding=padding,
                              dilation=dilation, bias=bias)


class LinearNorm(nn.Module):
    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.linear_layer = nn.Linear(cin, cout, bias=bias)


class ConvBlock(nn.Module):
    """n_conv residual sub-blocks: conv (dilation 3^i) -> relu ->
    GroupNorm(8) -> dropout -> conv -> relu -> dropout."""

    def __init__(self, hidden: int, n_conv: int = 3, dropout_p: float = 0.2):
        super().__init__()
        self.dropout_p = dropout_p
        self.blocks = nn.ModuleList([nn.ModuleDict({
            "0": ConvNorm(hidden, hidden, 3, padding=3 ** i, dilation=3 ** i),
            "2": nn.GroupNorm(8, hidden),
            "4": ConvNorm(hidden, hidden, 3, padding=1),
        }) for i in range(n_conv)])

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        for blk in self.blocks:
            h = torch.relu(L.conv1d(blk["0"].conv, x))
            h = L.dropout(L.group_norm(blk["2"], h), self.dropout_p, gen)
            h = torch.relu(L.conv1d(blk["4"].conv, h))
            x = x + L.dropout(h, self.dropout_p, gen)
        return x


class LocationLayer(nn.Module):
    def __init__(self, attn_dim: int, n_filters: int = 32, kernel: int = 63):
        super().__init__()
        self.location_conv = ConvNorm(2, n_filters, kernel,
                                      padding=(kernel - 1) // 2, bias=False)
        self.location_dense = LinearNorm(n_filters, attn_dim, bias=False)


class Attention(nn.Module):
    """Location-sensitive attention (reference ASR/layers.py:133-208)."""

    def __init__(self, rnn_dim: int, embed_dim: int, attn_dim: int):
        super().__init__()
        self.query_layer = LinearNorm(rnn_dim, attn_dim, bias=False)
        self.memory_layer = LinearNorm(embed_dim, attn_dim, bias=False)
        self.v = LinearNorm(attn_dim, 1, bias=False)
        self.location_layer = LocationLayer(attn_dim)

    def forward(self, query: torch.Tensor, memory: torch.Tensor,
                processed_memory: torch.Tensor, weights_cat: torch.Tensor,
                pad_mask: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query (B, rnn); memory (B, L, H); weights_cat (B, L, 2) [previous,
        cumulative]; pad_mask (B, L) True = pad -> (context (B, H),
        weights (B, L))."""
        pq = L.linear(self.query_layer.linear_layer, query)[:, None, :]
        loc = self.location_layer
        pa = L.linear(loc.location_dense.linear_layer,
                      L.conv1d(loc.location_conv.conv, weights_cat))
        energies = L.linear(self.v.linear_layer,
                            torch.tanh(pq + pa + processed_memory))[..., 0]
        if pad_mask is not None:
            energies = energies.masked_fill(pad_mask, float("-inf"))
        weights = torch.softmax(energies.float(), dim=1).to(memory.dtype)
        return torch.einsum("bl,blh->bh", weights, memory), weights


class ASRS2S(nn.Module):
    """Teacher-forced attention decoder (reference ASR/models.py:74-186)."""

    def __init__(self, embedding_dim: int = 512, hidden_dim: int = 128,
                 n_token: int = 178):
        super().__init__()
        self.embedding = nn.Embedding(n_token, embedding_dim)
        self.project_to_n_symbols = nn.Linear(hidden_dim, n_token)
        self.attention_layer = Attention(hidden_dim, hidden_dim, hidden_dim)
        self.decoder_rnn = nn.LSTMCell(hidden_dim + embedding_dim, hidden_dim)
        self.project_to_hidden = nn.ModuleList(
            [LinearNorm(hidden_dim * 2, hidden_dim)])

    def forward(self, memory: torch.Tensor, mem_pad_mask: torch.Tensor,
                text: torch.Tensor, gen: Optional[torch.Generator] = None,
                sos: int = 1, unk: int = 3, random_mask: float = 0.1,
                dropout_p: float = 0.5
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """memory (B, L, H); mem_pad_mask (B, L) True = pad; text (B, T).
        gen: train mode (10% of tokens -> unk, dropout on the hidden state).
        Returns (hidden (B, T+1, H), logits (B, T+1, n_token),
        attention (B, T+1, L))."""
        b, l, h = memory.shape
        if gen is not None:
            masked = L.rand_rows(text.shape, gen, text.device) < random_mask
            text = torch.where(masked, torch.full_like(text, unk), text)
        emb = self.embedding(text)
        sos_emb = self.embedding.weight[sos][None, None, :].expand(
            b, 1, emb.shape[-1])
        dec_in = torch.cat([sos_emb, emb], dim=1)  # (B, T+1, E)
        att = self.attention_layer
        processed = L.linear(att.memory_layer.linear_layer, memory)
        rnn = self.decoder_rnn.hidden_size
        hs = memory.new_zeros(b, rnn)
        cs = torch.zeros(b, rnn, device=memory.device)
        aw = memory.new_zeros(b, l)
        aw_cum = memory.new_zeros(b, l)
        ctx = memory.new_zeros(b, h)
        hiddens, logits, aligns = [], [], []
        for t in range(dec_in.shape[1]):
            hs, cs = L.lstm_cell(self.decoder_rnn,
                                 torch.cat([dec_in[:, t], ctx], dim=-1),
                                 hs, cs)
            ctx, aw = att(hs, memory, processed,
                          torch.stack([aw, aw_cum], dim=-1), mem_pad_mask)
            aw_cum = aw_cum + aw
            hidden = torch.tanh(L.linear(
                self.project_to_hidden[0].linear_layer,
                torch.cat([hs, ctx], dim=-1)))
            logits.append(L.linear(self.project_to_n_symbols,
                                   L.dropout(hidden, dropout_p, gen)))
            hiddens.append(hidden)
            aligns.append(aw)
        return (torch.stack(hiddens, 1), torch.stack(logits, 1),
                torch.stack(aligns, 1))


class ASRCNN(nn.Module):
    """The aligner (reference ASR/models.py:8-72)."""

    def __init__(self, input_dim: int = 80, hidden_dim: int = 256,
                 n_token: int = 178, n_layers: int = 6,
                 token_embedding_dim: int = 512):
        super().__init__()
        self.init_cnn = ConvNorm(input_dim // 2, hidden_dim, 7, stride=2,
                                 padding=3)
        self.cnns = nn.ModuleList([nn.ModuleDict({
            "0": ConvBlock(hidden_dim), "1": nn.GroupNorm(1, hidden_dim)})
            for _ in range(n_layers)])
        self.projection = ConvNorm(hidden_dim, hidden_dim // 2)
        self.ctc_linear = nn.ModuleDict({
            "0": LinearNorm(hidden_dim // 2, hidden_dim),
            "2": LinearNorm(hidden_dim, n_token)})
        self.asr_s2s = ASRS2S(token_embedding_dim, hidden_dim // 2, n_token)

    def get_feature(self, mel_norm: torch.Tensor,
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, n_mels, T) normalised log-mel -> (B, T // 2, H / 2)."""
        x = OPS.mfcc(mel_norm).transpose(1, 2)
        x = L.conv1d(self.init_cnn.conv, x)
        for blk in self.cnns:
            x = L.group_norm(blk["1"], blk["0"](x, gen))
        return L.conv1d(self.projection.conv, x)

    def forward(self, mel_norm: torch.Tensor, mem_pad_mask: torch.Tensor,
                text: torch.Tensor, gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (ctc logits (B, L, n_token), s2s logits (B, T+1,
        n_token), s2s attention (B, T+1, L)), L = T_mel // 2."""
        x = self.get_feature(mel_norm, gen)
        ctc = L.linear(self.ctc_linear["2"].linear_layer, F.relu(
            L.linear(self.ctc_linear["0"].linear_layer, x)))
        _, s2s_logit, s2s_attn = self.asr_s2s(x, mem_pad_mask, text, gen)
        return ctc, s2s_logit, s2s_attn
