"""SLM (speech-language-model) adversarial training stage.

Counterpart of styletts2_tpu/nn/slm.py (reference Modules/slmadv.py:5-170,
upstream StyleTTS2's stage that the lite fork keeps on disk but never
calls):

* differentiable durations: a gaussian (sigma 1.5) soft alignment around
  the cumulative duration centres, so the SLM discriminator's gradient
  reaches the duration predictor (slmadv.py:36-55), as one masked softmax
  over (token, frame) distances;
* the WavLM backbone (nn/wavlm.py, frozen) embeds the synthesized audio,
  the discriminator head is nn/discriminators.py WavLMDiscriminator;
* the lite model's 128-dim ref_s conditions both predictor and decoder.

Eager per (crop, text length), like the port's D/G step. The generator
step differentiates only `predictor` and `decoder` (JAX's trained
modules): the text encoder runs without gradient, the style is detached,
WavLM has no trainable parameters but passes gradients to the waveform.
The decoder runs its masked plain route (weight norm split: no kernel
B1); the style mel goes through `preprocess_wave` (kernel B2 on CUDA).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch

from styletts2_tpu_torch import losses as LO
from styletts2_tpu_torch import train as TT
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.nn import decoder as DE
from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.nn import wavlm as WL
from styletts2_tpu_torch.nn.discriminators import WavLMDiscriminator
from styletts2_tpu_torch.ops import stft as OPS
from styletts2_tpu_torch.parallel import mesh as PM


def soft_alignment_from_durations(dur_logits: torch.Tensor,
                                  text_mask: torch.Tensor, n_frames: int,
                                  sig: float = 1.5) -> torch.Tensor:
    """dur_logits (B, T, max_dur), text_mask (B, T) -> (B, T, n_frames):
    the softmax over tokens of a gaussian centred at each token's
    cumulative-duration midpoint (slmadv.py:36-55)."""
    probs = torch.sigmoid(dur_logits.float())
    dur = probs.sum(dim=-1) * text_mask
    centers = torch.cumsum(dur, dim=1) - dur / 2.0
    t = torch.arange(n_frames, dtype=torch.float32,
                     device=dur.device)[None, None, :]
    logits = -0.5 * torch.square(t - centers[..., None]) / sig ** 2
    logits = torch.where(text_mask[..., None], logits,
                         torch.full((), -1e9, device=dur.device))
    return torch.softmax(logits, dim=1)


class SLMAdversarialLoss:
    """One SLM round's two losses over a losses.WavLMLoss."""

    def __init__(self, wl: LO.WavLMLoss, sig: float = 1.5):
        self.wl = wl
        self.sig = sig

    def generator_step(self, mods, texts: torch.Tensor,
                       text_lengths: torch.Tensor, ref_s: torch.Tensor,
                       n_frames: int,
                       source: Optional[DE.SourceDraws] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Synthesize through the differentiable durations: (SLM generator
        loss, y_pred (B, L, 1)). n_frames: the crop at the asr rate;
        source: the sine source's draws (None: zero phase and noise)."""
        t_text = texts.shape[1]
        mask = L.length_to_valid_mask(text_lengths, t_text)
        pred = mods["predictor"]
        with torch.no_grad():  # not trained here (JAX's trained_modules)
            t_en = mods["text_encoder"](texts, mask)
        d = pred.encode_duration(t_en, ref_s, mask)
        dur_logits = pred.duration_head(d, mask)

        attn_t = soft_alignment_from_durations(dur_logits, mask, n_frames,
                                               self.sig).transpose(1, 2)
        total = torch.clamp((torch.sigmoid(dur_logits).sum(dim=-1)
                             * mask).sum(dim=1), max=n_frames)
        frame_mask = (torch.arange(n_frames, device=texts.device)[None, :]
                      < total[:, None])
        mel_mask = torch.repeat_interleave(frame_mask, 2, dim=1)
        asr_pred = torch.matmul(attn_t, t_en)
        en = torch.matmul(attn_t, d)
        f0, n_en = pred.f0n(en, ref_s, mask=frame_mask, out_mask=mel_mask)
        y_pred = mods["decoder"](asr_pred, f0, n_en, ref_s, frame_mask,
                                 source)
        return self.wl.generator(y_pred[..., 0]), y_pred

    def discriminator_step(self, wav: torch.Tensor,
                           y_pred: torch.Tensor) -> torch.Tensor:
        """The SLM discriminator's LSGAN loss on (real, synthesized)
        audio, y_pred detached (slmadv.py:120-163)."""
        return self.wl.discriminator(wav, y_pred.detach())


class SLMAdversarialTrainer:
    """The opt-in SLM stage of the train loop: every `slmadv_params.iter`
    steps one generator step (gradients through the soft alignment and the
    frozen WavLM into predictor and decoder, applied by the loop's
    MultiOptimizer) and one discriminator step (the WavLM head, with its
    own AdamW). The real clip is the leading 2 * crop mel frames of each
    padded waveform (every sample is at least that long by the bin's crop
    bound)."""

    trained = ("predictor", "decoder")  # JAX's trained_modules

    def __init__(self, cfg, multi_opt, wl: LO.WavLMLoss, scale: float = 0.01,
                 sig: float = 1.5, mesh=None):
        from styletts2_tpu_torch.optim import make_adamw

        self.cfg = cfg
        # data-parallel ranks (parallel.Mesh): each round runs on this
        # rank's rows, its gradients (predictor and decoder; the head's,
        # whose AdamW state must stay in step) and losses averaged over
        # the ranks, the source drawn per row (layers.row_draws). The
        # round draws nothing at the texts' width and masks padded tokens
        # out exactly, so ranks whose texts pad to different widths need
        # no common width here (the D/G step pads them: pad_to_widest)
        self.mesh = mesh
        self.multi_opt = multi_opt
        self.wl = wl
        self.scale = scale
        self.loss = SLMAdversarialLoss(wl, sig)
        self.wd_opt = make_adamw(wl.wd.parameters(), cfg.optimizer_params.lr)

    def style(self, mods, waves: torch.Tensor) -> torch.Tensor:
        """ref_s of the batch: the style encoder on the padded waves' mels
        (kernel B2 on CUDA), detached."""
        mp = self.cfg.model_params
        sp = self.cfg.preprocess_params.spect_params
        mels = OPS.preprocess_wave(waves, sr=24000, n_fft=sp.n_fft,
                                   win_length=sp.win_length,
                                   hop_length=sp.hop_length, n_mels=mp.n_mels)
        with torch.no_grad():
            return mods["style_encoder"](mels)

    def generator_grads(self, mods, texts, text_lengths, waves, crop: int,
                        source: Optional[DE.SourceDraws] = None):
        """(scaled loss, y_pred, {module: grads}) of the generator step
        over the trained modules; no .grad is written anywhere."""
        loss, y_pred = self.loss.generator_step(
            mods, texts, text_lengths, self.style(mods, waves), crop, source)
        loss = loss * self.scale
        grads = TT._grads(loss, mods, self.trained)
        return loss.detach(), y_pred.detach(), grads

    def discriminator_grads(self, waves, y_pred, crop: int):
        """(loss, grads of the head's parameters)."""
        hop = self.cfg.preprocess_params.spect_params.hop_length
        loss = self.loss.discriminator_step(waves[:, : crop * 2 * hop],
                                            y_pred[..., 0])
        params = list(self.wl.wd.parameters())
        return loss.detach(), torch.autograd.grad(loss, params)

    def step(self, mods, texts, text_lengths, waves, crop: int,
             gen: Optional[torch.Generator],
             source: Optional[DE.SourceDraws] = None,
             times=None) -> Dict[str, torch.Tensor]:
        """One SLM round on a batch: {"slm_g", "slm_d"} as device scalars.
        gen draws the sine source's phase and noise unless `source` fixes
        them; times: a train.PhaseTimes, marked "slm_g" and "slm_d"."""
        mesh = self.mesh
        if source is None:
            spf = mods["decoder"].generator.source_samples_per_frame
            if spf:
                with L.row_draws(mesh):
                    source = DE.draw_source(gen, texts.shape[0],
                                            2 * crop * spf,
                                            device=waves.device)
        if times is not None:
            times.start()
        g_loss, y_pred, grads = self.generator_grads(
            mods, texts, text_lengths, waves, crop, source)
        if mesh is not None:
            TT.sync_grads(mesh, grads)
        TT._apply(self.multi_opt, mods, self.trained, grads)
        TT._mark(times, "slm_g")
        d_loss, d_grads = self.discriminator_grads(waves, y_pred, crop)
        d_grads = list(d_grads)
        if mesh is not None:
            TT.sync_grads(mesh, {"wavlm_d": d_grads})
        for p, g in zip(self.wl.wd.parameters(), d_grads):
            p.grad = g
        self.wd_opt.step()
        self.wd_opt.zero_grad(set_to_none=True)
        TT._mark(times, "slm_d")
        out = {"slm_g": g_loss, "slm_d": d_loss}
        return out if mesh is None else PM.mean_metrics(mesh, out)


def build_trainer(cfg, multi_opt, device, mesh=None):
    """The SLM trainer of `cfg.slmadv_params` (styletts2_tpu/train_loop.py
    :180-212): wavlm-base-plus from the local HF state dict at
    `wavlm_path`, or seeded random weights when `allow_random_wavlm`
    (smoke runs only; a warning), else a RuntimeError; the head seeded,
    weight norm split. mesh: data-parallel ranks (see
    SLMAdversarialTrainer)."""
    sp = cfg.slmadv_params
    wl_cfg = WL.WavLMConfig()
    wavlm = WL.WavLM(wl_cfg)
    if sp.wavlm_path:
        wavlm.load_hf_state_dict(torch.load(
            sp.wavlm_path, map_location="cpu", weights_only=True))
    elif not sp.allow_random_wavlm:
        raise RuntimeError(
            "slmadv_params.enabled requires slmadv_params.wavlm_path "
            "(a wavlm-base-plus state_dict): without pretrained WavLM "
            "weights the adversarial stage trains against noise. Set "
            "slmadv_params.allow_random_wavlm: true only for smoke "
            "tests.")
    else:
        logging.getLogger("styletts2_tpu_torch.train").warning(
            "slmadv enabled without wavlm_path: the WavLM backbone is "
            "RANDOMLY initialized (smoke only)")
        wavlm.init_random(torch.Generator().manual_seed(7))
    wavlm.to(device).eval().requires_grad_(False)
    wd = WavLMDiscriminator(wl_cfg.hidden_size, wl_cfg.num_hidden_layers + 1)
    W.init_random(wd, torch.Generator().manual_seed(8))
    W.split_weight_norm(wd)
    wd.to(device).train()
    return SLMAdversarialTrainer(cfg, multi_opt, LO.WavLMLoss(wavlm, wd),
                                 scale=sp.scale, sig=sp.sig, mesh=mesh)
