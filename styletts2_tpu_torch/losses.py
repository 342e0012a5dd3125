"""Loss library: multi-resolution mel STFT, LSGAN, feature matching, TPRLS,
and the SLM (WavLM) losses.

Counterpart of styletts2_tpu/losses.py (reference losses.py:7-252). The
"STFT" loss is mel-domain (128 mels) with the front end's log
normalisation, so each resolution is one call of kernel B2 per waveform on
CUDA (6 per step), differentiable through `ops.mel_kernel.log_mel`. The
median of TPRLS is torch's lower median, as in the reference.

`mesh` (data-parallel ranks, each holding its rows of the global batch):
the two losses that are not means over rows take the global batch's
value and gradient: the MRSTFT ratio of batch sums (parallel.global_sum)
and TPRLS's batch median (parallel.global_rows / global_loss).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from styletts2_tpu_torch.ops import stft as OPS
from styletts2_tpu_torch.parallel import mesh as PM

MRSTFT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               mesh=None) -> torch.Tensor:
    """Spectral-convergence L1 over the 3 mel resolutions: the mean of
    ||y_mag - x_mag||_1 / ||y_mag||_1. x, y: (B, T) waveforms."""
    x = x.float()
    y = y.float()
    total = 0.0
    for fft, hop, win in MRSTFT_RESOLUTIONS:
        kw = dict(sr=24000, n_fft=fft, win_length=win, hop_length=hop,
                  n_mels=128)
        x_mag = OPS.preprocess_wave(x, **kw)
        y_mag = OPS.preprocess_wave(y, **kw)
        diff, ref = (y_mag - x_mag).abs().sum(), y_mag.abs().sum()
        if mesh is not None:
            diff, ref = PM.global_sum(mesh, diff), PM.global_sum(mesh, ref)
        total = total + diff / ref
    return total / len(MRSTFT_RESOLUTIONS)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 * sum of mean |real - fake| over every feature map."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl.float() - gl.float()).abs().mean()
    return loss * 2.0


def generator_adv_loss(disc_outputs) -> torch.Tensor:
    """LSGAN generator loss: sum of mean((1 - D(G))^2)."""
    loss = 0.0
    for dg in disc_outputs:
        loss = loss + torch.square(1.0 - dg.float()).mean()
    return loss


def discriminator_adv_loss(disc_real, disc_fake) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(disc_real, disc_fake):
        loss = loss + torch.square(1.0 - dr.float()).mean()
        loss = loss + torch.square(dg.float()).mean()
    return loss


def _tprls_term(dr: torch.Tensor, dg: torch.Tensor,
                tau: float = 0.04, mesh=None) -> torch.Tensor:
    """Relativistic median loss (reference losses.py:131-147); with a mesh
    over the global batch's rows."""
    if mesh is not None:
        return PM.global_loss(mesh, _tprls_term(
            *PM.global_rows(mesh, [dr.float(), dg.float()]), tau))
    diff = dr.float() - dg.float()
    m = torch.median(diff)  # lower median, as torch.median in the reference
    sel = dr.float() < dg.float() + m
    cnt = torch.clamp(sel.sum(), min=1)
    l_rel = torch.where(sel, torch.square(diff - m),
                        torch.zeros((), device=diff.device)).sum() / cnt
    return tau - torch.relu(tau - l_rel)


def discriminator_tprls_loss(disc_real, disc_fake,
                             mesh=None) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(disc_real, disc_fake):
        loss = loss + _tprls_term(dr, dg, mesh=mesh)
    return loss


def generator_tprls_loss(disc_real, disc_fake, mesh=None) -> torch.Tensor:
    """The reference's generator TPRLS swaps the zip binding (losses.py:
    140-147), so its formula runs with dr = generated, dg = real; kept."""
    loss = 0.0
    for dr, dg in zip(disc_real, disc_fake):
        loss = loss + _tprls_term(dg, dr, mesh=mesh)
    return loss


def generator_loss(mpd, msd, y: torch.Tensor, y_hat: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """Adversarial + feature matching + TPRLS over MPD and MSD (reference
    losses.py:149-168). y, y_hat: (B, T)."""
    df_r, df_g, ff_r, ff_g = mpd(y, y_hat)
    ds_r, ds_g, fs_r, fs_g = msd(y, y_hat)
    return (generator_adv_loss(df_g) + generator_adv_loss(ds_g)
            + feature_loss(ff_r, ff_g) + feature_loss(fs_r, fs_g)
            + generator_tprls_loss(df_r, df_g, mesh)
            + generator_tprls_loss(ds_r, ds_g, mesh))


def discriminator_loss(mpd, msd, y: torch.Tensor, y_hat: torch.Tensor,
                       mesh=None) -> torch.Tensor:
    """Reference losses.py:170-190. y, y_hat: (B, T)."""
    df_r, df_g, _, _ = mpd(y, y_hat)
    ds_r, ds_g, _, _ = msd(y, y_hat)
    return (discriminator_adv_loss(df_r, df_g)
            + discriminator_adv_loss(ds_r, ds_g)
            + discriminator_tprls_loss(df_r, df_g, mesh)
            + discriminator_tprls_loss(ds_r, ds_g, mesh))


class WavLMLoss:
    """SLM feature and adversarial losses over a WavLM embedder
    (nn/wavlm.py; frozen by the caller) and its discriminator head
    (nn/discriminators.py WavLMDiscriminator). Waveforms arrive at the
    model's rate and are resampled linearly to the SLM's (24 -> 16 kHz:
    not an integer ratio, so interpolate_linear's general path)."""

    model_sr, slm_sr = 24000, 16000

    def __init__(self, wavlm: nn.Module, wd: nn.Module):
        self.wavlm = wavlm
        self.wd = wd

    def _resample(self, wav: torch.Tensor) -> torch.Tensor:
        out_len = int(wav.shape[-1] * self.slm_sr / self.model_sr)
        return OPS.interpolate_linear(wav, out_len)

    @staticmethod
    def _stack(hiddens: Sequence[torch.Tensor]) -> torch.Tensor:
        """[(B, L, H)] * n -> (B, L, n * H), the reference's
        stack(dim=1).transpose(-1, -2).flatten(1, 2) layout."""
        return torch.cat(list(hiddens), dim=-1)

    def _embed(self, wav: torch.Tensor) -> List[torch.Tensor]:
        return self.wavlm(self._resample(wav))

    def forward(self, wav: torch.Tensor, y_rec: torch.Tensor) -> torch.Tensor:
        """Mean |wavlm(wav) - wavlm(y_rec)| summed over the hidden states;
        wav (B, T) is the detached target."""
        loss = 0.0
        for r, g in zip(self._embed(wav.detach()), self._embed(y_rec)):
            loss = loss + (r - g).abs().mean()
        return loss

    def generator(self, y_rec: torch.Tensor) -> torch.Tensor:
        """LSGAN generator loss through the frozen WavLM: gradients reach
        y_rec (B, T)."""
        d_out = self.wd(self._stack(self._embed(y_rec)))
        return torch.square(1.0 - d_out).mean()

    def discriminator(self, wav: torch.Tensor,
                      y_rec: torch.Tensor) -> torch.Tensor:
        """LSGAN discriminator loss on (real, synthesized) embeddings, both
        detached: only the head gets gradients."""
        d_r = self.wd(self._stack(self._embed(wav.detach())))
        d_g = self.wd(self._stack(self._embed(y_rec.detach())))
        return torch.square(1.0 - d_r).mean() + torch.square(d_g).mean()
