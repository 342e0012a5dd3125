"""Training: the StyleTTS2-lite finetune step (D step, then G step).

Counterpart of styletts2_tpu/train.py (reference train.py:184-357):

* monotonic alignment runs on the device (ops/align.py), no host trip;
* per-sample loops (crops, duration/CE losses) are batched gathers and
  masked batched forms;
* mel spectrograms come from the padded waveforms on the device, through
  kernel B2 (`compute_mels`: once in the D step, once in the G step; the
  MRSTFT loss: 6 more in the G step);
* GAN ordering as in the reference: the discriminators update on detached
  audio first, then the generator loss runs against the UPDATED
  discriminators, from the same random draws (`make_train_step` replays
  the generator's state);
* modes as the reference's (train.py:190-196): aligner, text encoder and
  predictor draw dropout, decoder and style encoder do not, the pitch
  extractor is frozen.

Every random draw (dropout, the aligner's unk masking, the 50% soft/mono
coin, the crop starts, the sine source's phase and noise) comes from one
explicit `torch.Generator`; `Draws` fixes the coin, the crops and the
source instead (parity tests). The decoder runs its plain differentiable
route (no frame mask, so no kernel B1), as JAX's step passes no n_valid.
`remat` recomputes the decoder synthesis and the generator-side
discriminators in the backward (torch.utils.checkpoint); `grad_accum`
averages each step's gradients over equal micro-batches.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from styletts2_tpu_torch import losses as LO
from styletts2_tpu_torch.config import Config, LossParams, ModelConfig
from styletts2_tpu_torch.nn import decoder as DE
from styletts2_tpu_torch.nn import layers as L
from styletts2_tpu_torch.ops import align as ALN
from styletts2_tpu_torch.ops import stft as OPS

GEN_MODULES = ("predictor", "style_encoder", "decoder", "text_encoder",
               "text_aligner")
DISC_MODULES = ("msd", "mpd")


@dataclass
class Batch:
    """One padded training batch (static shapes per duration bin)."""
    waves: torch.Tensor          # (B, L_wav) f32, includes the 0.5 s pads
    texts: torch.Tensor          # (B, T_text) int64
    input_lengths: torch.Tensor  # (B,) int64 text lengths
    mel_lengths: torch.Tensor    # (B,) int64 mel frame counts (even)

    @classmethod
    def from_numpy(cls, nb, device) -> "Batch":
        """From a data.loader.NumpyBatch (or anything with its fields)."""
        def put(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(device=device,
                                                     dtype=dtype)

        return cls(put(nb.waves, torch.float32), put(nb.texts, torch.int64),
                   put(nb.input_lengths, torch.int64),
                   put(nb.mel_lengths, torch.int64))

    def split(self, n: int) -> List["Batch"]:
        b = self.waves.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by grad_accum {n}")
        m = b // n
        return [Batch(*(t[i * m:(i + 1) * m] for t in
                        (self.waves, self.texts, self.input_lengths,
                         self.mel_lengths))) for i in range(n)]


@dataclass
class Draws:
    """Random draws of one generator forward fixed by the caller.

    coin: True = soft attention, False = the monotonic path (None: drawn);
    starts: (B,) crop starts at the half-mel rate (None: drawn);
    source: the sine source's (rand_ini, noise) (None: drawn);
    dropout: False turns off train-mode dropout and unk masking."""
    coin: Optional[bool] = None
    starts: Optional[torch.Tensor] = None
    source: Optional[DE.SourceDraws] = None
    dropout: bool = True

    def split(self, n: int) -> List["Draws"]:
        def part(t, i):
            if t is None:
                return None
            m = t.shape[0] // n
            return t[i * m:(i + 1) * m]

        return [replace(self, starts=part(self.starts, i),
                        source=None if self.source is None else
                        (part(self.source[0], i), part(self.source[1], i)))
                for i in range(n)]


class PhaseTimes:
    """Wall ms of the step's phases, device-synchronised at each mark; a
    step without one runs unsynchronised."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms: Dict[str, float] = {}
        self._t = None

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self) -> None:
        self._t = self._now()

    def mark(self, name: str) -> None:
        now = self._now()
        self.ms[name] = self.ms.get(name, 0.0) + (now - self._t) * 1e3
        self._t = now


def _mark(times: Optional[PhaseTimes], name: str) -> None:
    if times is not None:
        times.mark(name)


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """F.smooth_l1_loss (beta 1), mean."""
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def compute_mels(waves: torch.Tensor, cfg: ModelConfig, sp) -> torch.Tensor:
    """(B, L) padded waveforms -> (B, n_mels, T) normalised log-mels (kernel
    B2 on CUDA), truncated to an even frame count (reference
    meldataset.py:93-97)."""
    mel = OPS.preprocess_wave(waves, sr=24000, n_fft=sp.n_fft,
                              win_length=sp.win_length,
                              hop_length=sp.hop_length, n_mels=cfg.n_mels)
    t = mel.shape[-1]
    return mel[..., : t - t % 2]


def _crop(x: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """x[b, s_b : s_b + size] along dim 1 for each row, the start clamped so
    the window fits (lax.dynamic_slice semantics). A gather: no host
    sync."""
    starts = torch.clamp(starts, max=x.shape[1] - size)
    idx = starts[:, None] + torch.arange(size, device=x.device)
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def generator_forward(mods, batch: Batch, mels: torch.Tensor,
                      gen: Optional[torch.Generator], cfg: ModelConfig,
                      crop_frames: int, train: bool = True, hop: int = 300,
                      remat: bool = False, draws: Optional[Draws] = None):
    """Shared generator-side forward (reference train.py:202-267).

    crop_frames: the crop at the half-mel rate (the reference's mel_len);
    hop: mel hop in samples (a half-mel frame is 2 * hop samples); gen: the
    draws `draws` does not fix; train: dropout, unk masking and the coin.
    Returns (y_rec (B, L), wav crop (B, L), aux dict for the losses)."""
    draws = draws or Draws()
    b = mels.shape[0]
    dev = mels.device
    l_half = mels.shape[-1] // 2
    t_text = batch.texts.shape[1]
    dgen = gen if (train and draws.dropout) else None

    mel_half_len = batch.mel_lengths // 2
    mel_pad_mask = ~L.length_to_valid_mask(mel_half_len, l_half)
    text_valid = L.length_to_valid_mask(batch.input_lengths, t_text)

    # aligner; drop the sos step (train.py:206-209)
    _, s2s_pred, s2s_attn = mods["text_aligner"](mels, mel_pad_mask,
                                                 batch.texts, dgen)
    s2s_attn = s2s_attn[:, 1:, :]
    mask_st = ALN.mask_from_lens(batch.input_lengths, mel_half_len, t_text,
                                 l_half)
    attn_masked = torch.where(mask_st, s2s_attn,
                              torch.zeros((), device=dev))
    mono = ALN.maximum_path(attn_masked.detach(), batch.input_lengths,
                            mel_half_len)

    # text encoding + the 50% soft/mono coin (train.py:217-223)
    t_en = mods["text_encoder"](batch.texts, text_valid, dgen)
    if draws.coin is not None:
        coin = torch.tensor(bool(draws.coin) and train, device=dev)
    elif train:
        coin = torch.rand((), generator=gen, device=dev) < 0.5
    else:
        coin = torch.tensor(False, device=dev)
    attn_use = torch.where(coin, attn_masked, mono)
    asr = torch.matmul(attn_use.transpose(1, 2), t_en)  # (B, L, C)
    d_gt = mono.sum(dim=-1)

    # prosody over the full utterance
    s_full = mods["style_encoder"](mels)
    dur_logits, p_feats = mods["predictor"](t_en, s_full, text_valid, mono,
                                            cfg.dropout, dgen)

    # per-sample random crop (train.py:235-256)
    max_start = torch.clamp(mel_half_len - crop_frames, min=0)
    if draws.starts is not None:
        starts = draws.starts.to(dev)
    else:
        u = torch.rand(b, generator=gen, device=dev)
        starts = torch.minimum((u * (max_start + 1).float()).long(),
                               max_start)
    en = _crop(asr, starts, crop_frames)
    p_en = _crop(p_feats, starts, crop_frames)
    gt = _crop(mels.transpose(1, 2), starts * 2,
               2 * crop_frames).transpose(1, 2)
    wav = _crop(batch.waves, starts * 2 * hop, crop_frames * 2 * hop)

    # acoustic targets + synthesis (train.py:258-267)
    s_crop = mods["style_encoder"](gt)
    with torch.no_grad():
        f0_real = mods["pitch_extractor"](gt)[0]
        n_real = OPS.log_norm(gt)
    f0_fake, n_fake = mods["predictor"].f0n(p_en, s_crop,
                                            dropout_p=cfg.dropout, gen=dgen)
    dec = mods["decoder"]
    source = draws.source
    if source is None:
        source = DE.draw_source(gen, b, 2 * crop_frames * int(
            np.prod(dec.generator.rates)), device=dev)
    if remat:
        y_rec = checkpoint(dec, en, f0_fake, n_fake, s_crop, None, source,
                           use_reentrant=False)
    else:
        y_rec = dec(en, f0_fake, n_fake, s_crop, None, source)
    aux = {"s2s_pred": s2s_pred, "s2s_attn": attn_masked,
           "s2s_attn_mono": mono, "d_gt": d_gt, "dur_logits": dur_logits,
           "f0_real": f0_real, "f0_fake": f0_fake, "n_real": n_real,
           "n_fake": n_fake}
    return y_rec[..., 0], wav, aux


def generator_losses(mods, batch: Batch, mels: torch.Tensor,
                     gen: Optional[torch.Generator], cfg: ModelConfig,
                     lp: LossParams, crop_frames: int, train: bool = True,
                     hop: int = 300, remat: bool = False,
                     draws: Optional[Draws] = None):
    """All generator-side losses (reference train.py:279-315), batched and
    masked. remat also recomputes the generator-side MPD/MSD forwards.
    Returns (g_loss, (y_rec, wav, metrics))."""
    y_rec, wav, aux = generator_forward(mods, batch, mels, gen, cfg,
                                        crop_frames, train, hop, remat, draws)
    b, t_text = batch.texts.shape
    dev = mels.device
    text_valid = L.length_to_valid_mask(batch.input_lengths, t_text)

    loss_f0 = smooth_l1(aux["f0_real"], aux["f0_fake"]) / 10.0
    loss_norm = smooth_l1(aux["n_real"], aux["n_fake"])
    loss_mel = LO.multi_resolution_stft_loss(y_rec, wav)
    if remat:
        loss_gen = checkpoint(LO.generator_loss, mods["mpd"], mods["msd"],
                              wav, y_rec, use_reentrant=False)
    else:
        loss_gen = LO.generator_loss(mods["mpd"], mods["msd"], wav, y_rec)

    # duration + CE losses (train.py:284-299), masked batched forms
    dur_logits = aux["dur_logits"].float()
    d_gt = aux["d_gt"]
    max_dur = dur_logits.shape[-1]
    trg = (torch.arange(max_dur, device=dev)[None, None, :]
           < d_gt[..., None]).float()
    bce = (torch.clamp(dur_logits, min=0) - dur_logits * trg
           + torch.log1p(torch.exp(-torch.abs(dur_logits))))
    valid3 = text_valid[..., None].float()
    per_sample_ce = (bce * valid3).sum(dim=(1, 2)) / (
        torch.clamp(text_valid.sum(dim=1), min=1) * max_dur)
    loss_ce = per_sample_ce.sum() / b

    dur_pred = torch.sigmoid(dur_logits).sum(dim=-1)
    pos = torch.arange(t_text, device=dev)[None, :]
    inner = (text_valid & (pos >= 1)
             & (pos < (batch.input_lengths - 1)[:, None])).float()
    per_sample_dur = (torch.abs(dur_pred - d_gt) * inner).sum(dim=1) / \
        torch.clamp(inner.sum(dim=1), min=1)
    loss_dur = per_sample_dur.sum() / b

    # aligner s2s CE over the first `len` decoder steps (train.py:301-304)
    logp = F.log_softmax(aux["s2s_pred"].float(), dim=-1)
    steps = logp.shape[1]
    step_valid = L.length_to_valid_mask(batch.input_lengths, steps).float()
    tgt = F.pad(batch.texts, (0, steps - t_text))
    nll = -torch.gather(logp, 2, tgt[..., None])[..., 0]
    per_sample_s2s = (nll * step_valid).sum(dim=1) / \
        torch.clamp(step_valid.sum(dim=1), min=1)
    loss_s2s = per_sample_s2s.sum() / b

    # F.l1_loss over tensors padded to the batch max (train.py:307): sum
    # over valid / (B * maxT * maxL_half)
    mono_diff = torch.abs(aux["s2s_attn"] - aux["s2s_attn_mono"]).sum()
    denom = (b * batch.input_lengths.max()
             * (batch.mel_lengths // 2).max()).float()
    loss_mono = mono_diff / denom * 10.0

    g_loss = (lp.lambda_mel * loss_mel + lp.lambda_F0 * loss_f0
              + lp.lambda_ce * loss_ce + lp.lambda_norm * loss_norm
              + lp.lambda_dur * loss_dur + lp.lambda_gen * loss_gen
              + lp.lambda_mono * loss_mono + lp.lambda_s2s * loss_s2s)
    metrics = {"mel": loss_mel, "gen": loss_gen, "ce": loss_ce,
               "dur": loss_dur, "norm": loss_norm, "f0": loss_f0,
               "s2s": loss_s2s, "mono": loss_mono}
    return g_loss, (y_rec, wav, metrics)


def _grads(loss: torch.Tensor, mods, keys: Sequence[str]
           ) -> Dict[str, List[torch.Tensor]]:
    """d loss / d params of the given modules only (a parameter the loss
    does not reach gets zeros, as under jax.grad, so AdamW still decays
    it)."""
    params = [p for k in keys for p in mods[k].parameters()]
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    out, i = {}, 0
    for k in keys:
        n = len(list(mods[k].parameters()))
        out[k] = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(params[i:i + n], gs[i:i + n])]
        i += n
    return out


def make_grad_fns(cfg: Config, crop_frames: Optional[int] = None):
    """(d_grads, g_grads) for one (micro-)batch.

    d_grads(mods, batch, gen, draws) -> (d_loss, {module: grads}) over
    DISC_MODULES; g_grads(mods, batch, gen, draws) -> (metrics incl.
    g_loss, {module: grads}) over GEN_MODULES. The same generator state
    (or the same draws) reproduces the identical generator forward."""
    mp = cfg.model_params
    lp = cfg.loss_params
    sp = cfg.preprocess_params.spect_params
    remat = cfg.tpu.remat
    crop = crop_frames if crop_frames is not None else cfg.max_len // 2
    # the cropped-gt style encoder needs >= 66 mel frames
    if crop * 2 < 66:
        raise ValueError(f"max_len/crop too small: gt mels {2 * crop} < 66")

    def d_grads(mods, batch: Batch, gen, draws=None):
        mels = compute_mels(batch.waves, mp, sp)
        with torch.no_grad():
            y_rec, wav, _ = generator_forward(mods, batch, mels, gen, mp,
                                              crop, True, sp.hop_length,
                                              draws=draws)
        d_loss = LO.discriminator_loss(mods["mpd"], mods["msd"], wav, y_rec)
        return d_loss.detach(), _grads(d_loss, mods, DISC_MODULES)

    def g_grads(mods, batch: Batch, gen, draws=None):
        """mods must already hold the D-updated mpd/msd."""
        mels = compute_mels(batch.waves, mp, sp)
        g_loss, (_, _, metrics) = generator_losses(
            mods, batch, mels, gen, mp, lp, crop, True, sp.hop_length,
            remat, draws)
        grads = _grads(g_loss, mods, GEN_MODULES)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["g_loss"] = g_loss.detach()
        return metrics, grads

    return d_grads, g_grads


def _accumulate(fn: Callable, mods, batch: Batch, gen, accum: int,
                draws: Optional[Draws]):
    """Mean of fn's (aux, grads) over `accum` equal micro-batches, run one
    after the other (one micro-batch's activations live at a time). Loss
    normalisers that use the batch's maxima (loss_mono) see each
    micro-batch's own, as in JAX's grad_accum."""
    parts = draws.split(accum) if draws is not None else [None] * accum
    total = None
    for mb, dr in zip(batch.split(accum), parts):
        aux, grads = fn(mods, mb, gen, dr)
        if total is None:
            total = (aux, grads)
            continue
        t_aux, t_grads = total
        if isinstance(aux, dict):
            t_aux = {k: t_aux[k] + aux[k] for k in aux}
        else:
            t_aux = t_aux + aux
        for k in grads:
            t_grads[k] = [a + g for a, g in zip(t_grads[k], grads[k])]
        total = (t_aux, t_grads)
    aux, grads = total
    aux = ({k: v / accum for k, v in aux.items()} if isinstance(aux, dict)
           else aux / accum)
    return aux, {k: [g / accum for g in gs] for k, gs in grads.items()}


def _apply(multi_opt, mods, keys, grads) -> None:
    for k in keys:
        for p, g in zip(mods[k].parameters(), grads[k]):
            p.grad = g
        multi_opt.step(k)


def make_step_pair(cfg: Config, multi_opt, crop_frames: Optional[int] = None):
    """(d_step, g_step), each one module group's gradients and its AdamW
    updates. d_step updates the discriminators on detached audio; g_step
    must run after it, against the updated discriminators, with the same
    generator state. cfg.tpu.grad_accum > 1 averages the gradients over
    that many micro-batches before the one update."""
    accum = cfg.tpu.grad_accum
    d_grads, g_grads = make_grad_fns(cfg, crop_frames)

    def run(fn, mods, batch, gen, draws):
        if accum == 1:
            return fn(mods, batch, gen, draws)
        return _accumulate(fn, mods, batch, gen, accum, draws)

    def d_step(mods, batch: Batch, gen, draws=None, times=None):
        d_loss, grads = run(d_grads, mods, batch, gen, draws)
        _mark(times, "d_grads")
        _apply(multi_opt, mods, DISC_MODULES, grads)
        _mark(times, "d_opt")
        return d_loss

    def g_step(mods, batch: Batch, gen, draws=None, times=None):
        metrics, grads = run(g_grads, mods, batch, gen, draws)
        _mark(times, "g_grads")
        _apply(multi_opt, mods, GEN_MODULES, grads)
        _mark(times, "g_opt")
        return metrics

    return d_step, g_step


def make_train_step(cfg: Config, multi_opt, crop_frames: Optional[int] = None):
    """train_step(mods, batch, gen, draws=None, times=None) -> metrics: the
    D step, then the G step from the generator state the D step started
    from (reference train.py:272-328). times: a PhaseTimes to fill."""
    d_step, g_step = make_step_pair(cfg, multi_opt, crop_frames)

    def train_step(mods, batch: Batch, gen: torch.Generator,
                   draws: Optional[Draws] = None,
                   times: Optional[PhaseTimes] = None) -> Dict[str, Any]:
        state = gen.get_state()
        if times is not None:
            times.start()
        d_loss = d_step(mods, batch, gen, draws, times)
        gen.set_state(state)
        metrics = g_step(mods, batch, gen, draws, times)
        metrics["d_loss"] = d_loss
        return metrics

    return train_step


def eval_step_fn(cfg: Config, crop_frames: Optional[int] = None):
    """Validation metrics (reference train.py:363-463): the generator losses
    in eval mode (no dropout, no coin), no gradients."""
    mp = cfg.model_params
    lp = cfg.loss_params
    sp = cfg.preprocess_params.spect_params
    crop = crop_frames if crop_frames is not None else cfg.max_len // 2

    @torch.no_grad()
    def eval_step(mods, batch: Batch, gen, draws=None) -> Dict[str, Any]:
        mels = compute_mels(batch.waves, mp, sp)
        _, (_, _, metrics) = generator_losses(mods, batch, mels, gen, mp, lp,
                                              crop, False, sp.hop_length,
                                              draws=draws)
        return metrics

    return eval_step
