"""Sequence-parallel (frame-sharded) vocoder decode over a mesh of ranks.

Counterpart of styletts2_tpu/parallel/seqpar.py: one long chunk's decode
(most of phase 2's work) splits its time axis over the ranks instead of
running on one device. Exact, not approximate:

* every rank holds the whole inputs (the aligned text features at the asr
  rate, the F0/energy curves at the mel rate) and decodes its core
  interval of F / N asr frames plus a `margin`-frame halo on each side.
  Everything between input and waveform is a conv or elementwise op of
  finite reach, so with margin >= the decoder's receptive field
  (`decoder_receptive_field`) every core sample is computed exactly from
  the window. Outside [0, F) the window reads zeros, which is what the
  single device's SAME convs see at the sequence ends (JAX's ppermute
  zero fill), and the decoder re-zeroes those slots after every norm
  (the window's frame mask);
* the AdaIN instance norms take global statistics: each rank reduces over
  its core region and the (sum, count) and then the centred sums of
  squares are all-reduced (nn/layers.py SeqParCtx); kernel B1 is gated
  off inside a window (nn/blocks.py), as in JAX;
* the NSF harmonic source's sine phase is a cumsum over the WHOLE
  waveform: every rank computes it from the whole F0 curve, so the phase
  equals the single-device decode's, and passes its window's slice;
* Vocos's iSTFT overlap-add sees the global frame grid (`seq_mask`);
  iSTFTNet's replicate-padded source STFT is computed whole and its last
  stage runs in reflection-padded grid coordinates (`seq_win`, see
  nn/istftnet.py), the last rank claiming the grid's extra tail slot for
  the statistics (layers._seqpar_core_mask);
* each rank's core samples go into a zero-filled waveform that one
  all-reduce sums, so every rank returns the whole waveform.

Communication per decode: two KB-sized all-reduces per AdaIN and one of
the waveform; the activations never move. Its use is latency: N ranks
divide one long chunk's decode by about N at (F/N) / (F/N + 2 margin)
efficiency; for throughput, the data-parallel engine (batch rows over the
ranks) has no halo to recompute.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from styletts2_tpu_torch.config import DecoderConfig
from styletts2_tpu_torch.nn import layers as L

DEFAULT_MARGIN = 32  # asr frames; ~2x the default config's receptive field


def decoder_receptive_field(cfg: DecoderConfig) -> int:
    """Conservative one-sided receptive field of the decoder in asr
    frames: the least legal halo margin (styletts2_tpu/parallel/seqpar.py
    decoder_receptive_field, the same count).

    Shell (asr rate): encode + 4 decode AdainResBlk1d's, k3 convs, +-2
    each, +-10 in all. Generator in mel frames (halved for asr frames):
    HiFi-GAN and iSTFTNet per upsample stage the transposed conv's reach
    plus the widest dilated Snake/AdaIN stack over the stage's cumulative
    rate, conv_post's reach, and for iSTFTNet the iSTFT overlap-add's
    reach and the +1 reflection-pad shift; Vocos its num_layers depthwise
    k7 blocks plus the overlap-add's reach."""
    if cfg.type == "vocos":
        rf_mel = cfg.num_layers * 3.0
        rf_mel += math.ceil(cfg.gen_istft_n_fft / cfg.gen_istft_hop_size)
        return 10 + math.ceil(rf_mel / 2) + 1
    res_span = max(
        sum(d * (rk - 1) // 2 + (rk - 1) // 2 for d in rd)
        for rk, rd in zip(cfg.resblock_kernel_sizes,
                          cfg.resblock_dilation_sizes))
    rf_mel = 1.0  # F0/N stride-2 convs + nearest-neighbour F0 upsample
    prod = 1
    rates = cfg.upsample_rates
    for i, (u, k) in enumerate(zip(rates, cfg.upsample_kernel_sizes)):
        rf_mel += math.ceil(k / u) / prod
        prod *= u
        nk = 7 if i + 1 < len(rates) else 11  # noise_res kernel
        noise_span = sum(d * (nk - 1) // 2 + (nk - 1) // 2 for d in (1, 3, 5))
        rf_mel += max(res_span, noise_span) / prod
    rf_mel += math.ceil(7 / 2) / prod  # conv_post k7
    if cfg.type == "istftnet":
        rf_mel += (math.ceil(cfg.gen_istft_n_fft / cfg.gen_istft_hop_size)
                   + 1) / prod
    return 10 + math.ceil(rf_mel / 2) + 1


def _window(x: torch.Tensor, start: int, length: int, pad: int
            ) -> torch.Tensor:
    """x[:, start - pad : start - pad + length] along dim 1 of the whole
    sequence zero-padded by `pad` on both sides."""
    if x.dim() == 2:
        xp = F.pad(x, (pad, pad))
    else:
        xp = F.pad(x, (0, 0, pad, pad))
    return xp[:, start: start + length]


def sp_decoder_apply(mesh, decoder, asr: torch.Tensor, f0: torch.Tensor,
                     n: torch.Tensor, s: torch.Tensor, *,
                     margin: int = DEFAULT_MARGIN,
                     n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The frame-sharded `decoder(asr, f0, n, s, frame_mask)` over `mesh`:
    the single-device waveform up to the all-reduced statistics' rounding.

    Called by every rank of the mesh with the same full-length inputs:
    asr (B, F, 512) in the decoder dtype at the asr rate with F % N == 0;
    f0, n (B, 2F) f32 at the mel rate; s (B, style). Inference only (no
    source draws, no dropout). n_valid: optional (B,) per-row valid
    asr-frame prefix of a padded bucket, the single-device prefix
    frame_mask's equivalent (samples past it come back as the masked
    decode gives them). Returns the whole wav (B, F * 2 * samples per mel
    frame, 1) on every rank."""
    cfg = decoder.cfg
    if cfg.type not in ("hifigan", "istftnet", "vocos"):
        raise ValueError(f"unknown decoder type {cfg.type!r}")
    n_dev = mesh.size
    b, f_total, _ = asr.shape
    if f_total % n_dev:
        raise ValueError(f"F={f_total} not divisible by {n_dev} devices")
    core = f_total // n_dev
    need = decoder_receptive_field(cfg)
    if margin < need:
        raise ValueError(f"margin {margin} < receptive field bound {need}")
    if margin > core:
        raise ValueError(f"margin {margin} > per-device frames {core}; "
                         "use fewer devices or longer input")
    total_up = {  # samples per MEL frame
        "hifigan": int(np.prod(cfg.upsample_rates)),
        "istftnet": int(np.prod(cfg.upsample_rates)) * cfg.gen_istft_hop_size,
        "vocos": cfg.gen_istft_hop_size,
    }[cfg.type]
    spa = 2 * total_up  # samples per asr frame (mel = 2x the asr rate)
    dev = asr.device
    idx = mesh.rank
    width = core + 2 * margin
    start = idx * core  # window start in the margin-padded sequence
    limit = (torch.full((b,), f_total, dtype=torch.int64, device=dev)
             if n_valid is None
             else torch.as_tensor(n_valid, device=dev).to(torch.int64))

    asr_w = _window(asr, start, width, margin)
    f0_w = _window(f0, 2 * start, 2 * width, 2 * margin)
    n_w = _window(n, 2 * start, 2 * width, 2 * margin)
    gpos = idx * core - margin + torch.arange(width, device=dev)
    # the window's valid interval: the zero-filled outer margins of the
    # edge ranks read as zeros at every conv input (the decoder re-zeroes
    # masked slots after each norm); interior ranks of an unpadded decode
    # see an all-true mask
    frame_mask = (gpos[None, :] >= 0) & (gpos[None, :] < limit[:, None])

    kw = {}
    gen = decoder.generator
    if cfg.type != "vocos":
        # the source from the whole F0 curve, zeroed past the valid prefix
        # first (the decoder does the same through its mel mask)
        mel_pos = torch.arange(f0.shape[1], device=dev)[None, :]
        f0_g = torch.where(mel_pos < 2 * limit[:, None], f0,
                           torch.zeros((), device=dev))
    if cfg.type == "hifigan":
        from styletts2_tpu_torch.ops import stft as OPS

        f0_up = OPS.interpolate_nearest(f0_g[:, None, :], total_up)
        har = gen.m_source(f0_up.transpose(1, 2), total_up)  # (B, L, 1)
        kw["har_source"] = _window(har, start * spa, width * spa,
                                   margin * spa)
    elif cfg.type == "vocos":
        in_seq = (gpos >= 0) & (gpos < f_total)
        kw["seq_mask"] = in_seq[None, :].expand(b, -1)
    else:
        fr = spa // cfg.gen_istft_hop_size  # last-stage frames per asr frame
        har = gen.source_features(f0_g)  # (B, fr * F + 1, n_fft + 2)
        har_w = _window(har, start * fr, width * fr + 1, margin * fr)
        # reflection-PADDED grid coordinate of each last-stage window slot
        ppos = (idx * core - margin) * fr + torch.arange(har_w.shape[1],
                                                         device=dev)
        kw["seq_win"] = {
            "har": har_w,
            "pad0": ppos == 0,
            "grid": (ppos >= 0) & (ppos <= fr * f_total),
            "mask_pad": torch.where(
                ppos[None, :] == 0, (limit > 0)[:, None],
                (ppos[None, :] >= 1)
                & (ppos[None, :] - 1 < fr * limit[:, None])),
        }

    ctx = L.SeqParCtx(mesh, t_base=width, lo=margin, hi=margin + core)
    with L.seqpar_stats(ctx):
        wav_w = decoder(asr_w, f0_w, n_w, s, frame_mask=frame_mask, **kw)
    part = wav_w[:, margin * spa: (margin + core) * spa]
    return mesh.assemble(part, (b, f_total * spa) + tuple(part.shape[2:]),
                         1, idx * core * spa)
