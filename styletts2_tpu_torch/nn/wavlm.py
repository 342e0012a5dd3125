"""WavLM backbone (microsoft/wavlm-base-plus architecture): the SLM embedder
of the adversarial stage.

Counterpart of styletts2_tpu/nn/wavlm.py (the reference's `WavLMLoss`
loads the HF model from the hub and reads `output_hidden_states=True`).
The module's state-dict keys are HF `WavLMModel`'s, so a local
wavlm-base-plus state dict loads through `load_hf_state_dict` (the
positional conv's weight norm fused, `masked_spec_embed` dropped).

Architecture (HF `WavLMModel`, the base / non-stable-layer-norm variant):
* feature extractor: 7 bias-free conv1d layers (512 channels, strides
  5,2,2,2,2,2,2, kernels 10,3,3,3,3,2,2), exact GELU; GroupNorm(512, 512)
  after the first conv only (per-channel statistics over time);
* feature projection: LayerNorm(512) -> Linear(512 -> 768);
* encoder, post-norm: the grouped positional conv (k 128, groups 16,
  weight norm fused, the last frame trimmed since k is even) + GELU added
  to the input, then LayerNorm; layer 0's T5-style bucketed relative
  position bias (320 buckets, max distance 800), shared by every layer and
  gated per (batch, head, query) by each layer's own hidden states; 12
  heads of attention with the gated bias on the logits, softmax in f32;
  residual, LayerNorm, FFN(3072, GELU), residual, LayerNorm.

`forward` returns the [input to layer 0, ..., final] hidden states (13 for
12 layers). Everything is differentiable: the SLM generator loss reaches
the synthesized waveform THROUGH the frozen WavLM. Attention is plain
matmul and softmax, as JAX's is plain einsum outside any Pallas kernel.
Channels-last activations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from styletts2_tpu_torch.nn import layers as L


@dataclass
class WavLMConfig:
    """wavlm-base-plus defaults."""
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5


def feature_lengths(cfg: WavLMConfig, n_samples: int) -> int:
    """Output frame count of the conv feature extractor."""
    n = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        n = (n - k) // s + 1
    return n


class _Norm(nn.Module):
    """LayerNorm / GroupNorm parameters under HF's keys (weight, bias)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 group_norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=stride, bias=False)
        self.layer_norm = _Norm(c_out) if group_norm else None


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        c_in = [1] + list(cfg.conv_dim[:-1])
        self.conv_layers = nn.ModuleList([
            _ConvLayer(ci, c, k, s, i == 0) for i, (ci, c, k, s) in
            enumerate(zip(c_in, cfg.conv_dim, cfg.conv_kernel,
                          cfg.conv_stride))])


class _FeatureProjection(nn.Module):
    def __init__(self, c: int, h: int):
        super().__init__()
        self.layer_norm = _Norm(c)
        self.projection = nn.Linear(c, h)


class _PosConvEmbed(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        k = cfg.num_conv_pos_embeddings
        self.conv = nn.Conv1d(cfg.hidden_size, cfg.hidden_size, k,
                              padding=k // 2,
                              groups=cfg.num_conv_pos_embedding_groups)


class _Attention(nn.Module):
    def __init__(self, cfg: WavLMConfig, has_rel_embed: bool):
        super().__init__()
        h, heads = cfg.hidden_size, cfg.num_attention_heads
        self.heads = heads
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)
        self.gru_rel_pos_linear = nn.Linear(h // heads, 8)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
        self.rel_attn_embed = (nn.Embedding(cfg.num_buckets, heads)
                               if has_rel_embed else None)

    def forward(self, x: torch.Tensor,
                position_bias: torch.Tensor) -> torch.Tensor:
        """x (B, T, H); position_bias (heads, T, T), layer 0's."""
        b, t, h = x.shape
        hd = h // self.heads

        def split(y):  # (B, T, H) -> (B, heads, T, hd)
            return y.reshape(b, t, self.heads, hd).transpose(1, 2)

        # the gate, from the layer's own hidden states (HF
        # WavLMAttention.forward): a per-(batch, head, query) scalar on the
        # shared bias, broadcast over the key axis
        proj = L.linear(self.gru_rel_pos_linear, split(x))
        gate_a, gate_b = torch.sigmoid(
            proj.reshape(b, self.heads, t, 2, 4).sum(-1)).chunk(2, dim=-1)
        const = self.gru_rel_pos_const.to(x.dtype)
        gate = gate_a * (gate_b * const - 1.0) + 2.0  # (B, heads, T, 1)
        q = split(L.linear(self.q_proj, x)) * hd ** -0.5
        k = split(L.linear(self.k_proj, x))
        v = split(L.linear(self.v_proj, x))
        logits = torch.matmul(q, k.transpose(-1, -2)) + gate * position_bias
        w = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, t, h)
        return L.linear(self.out_proj, out)


class _FeedForward(nn.Module):
    def __init__(self, h: int, inner: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(h, inner)
        self.output_dense = nn.Linear(inner, h)


class _Layer(nn.Module):
    def __init__(self, cfg: WavLMConfig, first: bool):
        super().__init__()
        h = cfg.hidden_size
        self.attention = _Attention(cfg, first)
        self.layer_norm = _Norm(h)
        self.feed_forward = _FeedForward(h, cfg.intermediate_size)
        self.final_layer_norm = _Norm(h)


class _Encoder(nn.Module):
    def __init__(self, cfg: WavLMConfig):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(cfg)
        self.layer_norm = _Norm(cfg.hidden_size)
        self.layers = nn.ModuleList([_Layer(cfg, i == 0) for i in
                                     range(cfg.num_hidden_layers)])


def relative_positions_bucket(rel_pos: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5-style log-bucketed relative positions (HF
    WavLMAttention._relative_positions_bucket)."""
    nb = num_buckets // 2
    buckets = (rel_pos > 0).long() * nb
    rel = rel_pos.abs()
    max_exact = nb // 2
    rel_f = torch.clamp(rel.float(), min=1.0)
    large = (torch.log(rel_f / max_exact) / math.log(max_distance / max_exact)
             * (nb - max_exact) + max_exact).long()
    large = torch.clamp(large, max=nb - 1)
    return buckets + torch.where(rel < max_exact, rel, large)


class WavLM(nn.Module):
    """wavlm-base-plus (or a smaller WavLMConfig) under HF WavLMModel's
    state-dict keys."""

    def __init__(self, cfg: WavLMConfig = WavLMConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = _FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg.conv_dim[-1],
                                                     cfg.hidden_size)
        self.encoder = _Encoder(cfg)

    def position_bias(self, t: int, device) -> torch.Tensor:
        """(heads, T, T) relative position bias from layer 0's bucket
        embedding."""
        pos = torch.arange(t, device=device)
        buckets = relative_positions_bucket(pos[None, :] - pos[:, None],
                                            self.cfg.num_buckets,
                                            self.cfg.max_bucket_distance)
        emb = self.encoder.layers[0].attention.rel_attn_embed.weight
        return emb[buckets].permute(2, 0, 1)

    def forward(self, wav: torch.Tensor) -> List[torch.Tensor]:
        """wav (B, N) at 16 kHz -> [(B, L, hidden)] * (num_layers + 1), HF
        output_hidden_states order."""
        cfg = self.cfg
        eps = cfg.layer_norm_eps
        x = wav[..., None]
        for i, layer in enumerate(self.feature_extractor.conv_layers):
            x = L.conv1d(layer.conv, x)
            if i == 0:  # GroupNorm(C, C): per-channel statistics over time
                ln = layer.layer_norm
                xf = x.float()
                mean, var = L.masked_stats(xf, None)
                x = ((xf - mean) * torch.rsqrt(var + eps) * ln.weight
                     + ln.bias).to(x.dtype)
            x = L.gelu(x)

        fp = self.feature_projection
        x = L.plain_layer_norm(x, eps, fp.layer_norm.weight,
                               fp.layer_norm.bias)
        x = L.linear(fp.projection, x)

        enc = self.encoder
        pos = L.conv1d(enc.pos_conv_embed.conv, x)
        if cfg.num_conv_pos_embeddings % 2 == 0:
            pos = pos[:, :-1]
        x = L.plain_layer_norm(x + L.gelu(pos), eps, enc.layer_norm.weight,
                               enc.layer_norm.bias)
        bias = self.position_bias(x.shape[1], x.device).to(x.dtype)

        hiddens = [x]
        for layer in enc.layers:
            x = L.plain_layer_norm(x + layer.attention(x, bias), eps,
                                   layer.layer_norm.weight,
                                   layer.layer_norm.bias)
            ff = layer.feed_forward
            x = x + L.linear(ff.output_dense,
                             L.gelu(L.linear(ff.intermediate_dense, x)))
            x = L.plain_layer_norm(x, eps, layer.final_layer_norm.weight,
                                   layer.final_layer_norm.bias)
            hiddens.append(x)
        return hiddens

    def init_random(self, generator: torch.Generator) -> "WavLM":
        """Seeded random weights with the JAX package's init distributions
        (styletts2_tpu/nn/wavlm.py init): feature-extractor convs N(0,
        1/(C_in k)), the positional conv N(0, 4/(k H)) with a zero bias,
        linears U(+-1/sqrt(fan_in)) with their biases, the bucket
        embedding N(0, 0.02^2); norms and gate constants keep their
        construction values."""
        def fill(p, values):
            with torch.no_grad():
                p.copy_(values)

        for layer in self.feature_extractor.conv_layers:
            w = layer.conv.weight
            std = 1.0 / math.sqrt(w.shape[1] * w.shape[2])
            fill(w, torch.randn(w.shape, generator=generator) * std)
        pos = self.encoder.pos_conv_embed.conv
        std = math.sqrt(4.0 / (self.cfg.num_conv_pos_embeddings
                               * self.cfg.hidden_size))
        fill(pos.weight, torch.randn(pos.weight.shape, generator=generator)
             * std)
        fill(pos.bias, torch.zeros_like(pos.bias))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                for p in (m.weight, m.bias):
                    fill(p, (torch.rand(p.shape, generator=generator) * 2
                             - 1) * bound)
        emb = self.encoder.layers[0].attention.rel_attn_embed.weight
        fill(emb, torch.randn(emb.shape, generator=generator) * 0.02)
        return self

    def load_hf_state_dict(self, sd: Mapping[str, Any]) -> None:
        """Load an HF WavLMModel state dict (tensors or arrays), strictly:
        `masked_spec_embed` (train-time spec augment) is dropped, and the
        positional conv's weight norm, in the legacy (weight_g /
        weight_v) or the parametrized (parametrizations.weight.original0 /
        original1) naming, is fused as torch weight_norm(dim=2) defines
        it: norms over dims (0, 1), g of shape (1, 1, k)."""
        out, g, v = {}, None, None
        for key, val in sd.items():
            val = np.asarray(val.detach().cpu() if hasattr(val, "detach")
                             else val, dtype=np.float32)
            leaf = key.split(".")[-1]
            if key.split(".")[0] == "masked_spec_embed":
                continue
            if "pos_conv_embed" in key and leaf in ("weight_g", "original0"):
                g = val
            elif "pos_conv_embed" in key and leaf in ("weight_v", "original1"):
                v = val
            else:
                out[key] = torch.from_numpy(val.copy())
        if g is not None:  # in numpy, as the JAX package's converter
            norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
            out["encoder.pos_conv_embed.conv.weight"] = torch.from_numpy(
                (g * v / norm).astype(np.float32))
        self.load_state_dict(out, strict=True)
