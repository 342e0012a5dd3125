"""Inference engine: the user-facing StyleTTS2 API on PyTorch/CUDA.

Counterpart of styletts2_tpu/infer.py, with the same API:
  StyleTTS2(config, models_path, *, params, seed, decoder_dtype, device)
  .get_styles(speaker, denoise, avg_style, load_styles) -> style dict
  .generate(phonem, style, stabilize, n_merge) -> np.ndarray waveform
  .compute_style / .save_styles / .load_styles

Execution is the JAX engine's two-phase path, chunk by chunk at batch 1:
phase 1 (text encoder, duration encoder, duration head) on a token bucket;
host duration glue (stabilisation blend, z-score clamp, speed, rounding)
with the same numpy RNG stream as the JAX engine; phase 2 (alignment, F0/N,
decoder, int16 PCM) on a frame bucket, after splitting any chunk whose
frames overflow the largest bucket at token boundaries. The style mel runs
through kernel B2 and every generator conv pair through kernel B1 on CUDA.

Not ported yet: the fused single-dispatch path, chunk batching,
generate_stream / generate_batch / serve, the istftnet and vocos decoders.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from styletts2_tpu_torch import audio as AUD
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import Config, load_config
from styletts2_tpu_torch.models import build_inference_modules
from styletts2_tpu_torch.ops import align as ALN
from styletts2_tpu_torch.ops import stft as OPS
from styletts2_tpu_torch.text import (TextCleaner, build_symbol_dict,
                                      split_into_chunks, tokens_for_sentence)


def _bucket(buckets, n: int) -> int:
    i = bisect.bisect_left(buckets, n)
    if i == len(buckets):
        raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")
    return buckets[i]


def _split_spans(pred_dur: np.ndarray, max_frames: int) -> List[Tuple[int, int]]:
    """Split a chunk's tokens into contiguous spans whose duration sums each
    fit the largest frame bucket; every token keeps its duration, so the
    synthesized length equals the unsplit sum exactly."""
    if int(pred_dur.sum()) <= max_frames:
        return [(0, len(pred_dur))]
    spans: List[Tuple[int, int]] = []
    a = 0
    acc = 0
    for i, d in enumerate(pred_dur):
        if acc + int(d) > max_frames:
            spans.append((a, i))
            a, acc = i, 0
        acc += int(d)
    spans.append((a, len(pred_dur)))
    return spans


def _replace_outliers_zscore(x: np.ndarray, threshold: float = 3.0,
                             factor: float = 0.95) -> np.ndarray:
    """Clamp |z| > threshold values toward the mean (torch .std() is
    unbiased: ddof=1)."""
    if len(x) < 2:
        return x
    mean, std = x.mean(), x.std(ddof=1)
    if std == 0:
        return x
    z = (x - mean) / std
    out = np.abs(z) > threshold
    repl = mean + np.sign(x - mean) * (threshold * std * factor)
    y = x.copy()
    y[out] = repl[out]
    return y


class StyleTTS2:
    """Zero-shot TTS engine on one device (CUDA by default)."""

    def __init__(self, config, models_path: Optional[str] = None, *,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 decoder_dtype: Optional[str] = None, device="cuda"):
        """config: a Config or a YAML path. Weights: `params` ({module:
        numpy tree}, e.g. the JAX package's build_model output), else the
        `net` of the native .ckpt at `models_path`, else seeded random
        weights. device: "cuda" (the default) raises when no GPU is
        present; "cpu" must be asked for and runs the kernels' plain
        versions."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StyleTTS2(device='cuda'): no CUDA device is "
                               "available; pass device='cpu' to run on CPU")
        # f32 parity with the JAX package's true-f32 convs and matmuls:
        # cuDNN convolutions default to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg: Config = (config if isinstance(config, Config)
                            else load_config(config))
        mp = self.cfg.model_params
        self.symbol_dict = build_symbol_dict(self.cfg.symbol)
        self.cleaner = TextCleaner(self.symbol_dict, debug=self.cfg.debug)
        self.sr = self.cfg.preprocess_params.sr
        self.hop = self.cfg.preprocess_params.spect_params.hop_length
        self.ref_s: Optional[torch.Tensor] = None
        self._rng = np.random.default_rng(seed)
        # every token gets exactly this many frames when set (bypasses the
        # duration head): deterministic lengths for tests and load tests
        self.fixed_duration: Optional[int] = None
        # global multiplier on the duration head's raw output
        self.duration_scale: Optional[float] = None
        self.dtype = (torch.bfloat16 if (decoder_dtype or
                                         self.cfg.tpu.decoder_dtype)
                      == "bfloat16" else torch.float32)
        self.phase2_calls = 0

        self.modules = build_inference_modules(mp)
        if params is None and models_path:
            params = W.load_checkpoint_net(models_path)
        if params is not None:
            W.load_param_tree(self.modules, params, decoder_dtype=self.dtype)
        else:
            W.init_random(self.modules, torch.Generator().manual_seed(seed))
            self.modules["decoder"].prepack(self.dtype)
        self.modules.to(self.device).eval()

    # ------------------------------------------------------------------
    # the three device phases
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _style(self, wav: np.ndarray) -> torch.Tensor:
        """(B, T) waveform -> (B, style_dim)."""
        sp = self.cfg.preprocess_params.spect_params
        mel = OPS.preprocess_wave(
            torch.as_tensor(np.ascontiguousarray(wav, np.float32),
                            device=self.device),
            sr=self.sr, n_fft=sp.n_fft, win_length=sp.win_length,
            hop_length=self.hop, n_mels=self.cfg.model_params.n_mels)
        return self.modules["style_encoder"](mel)

    @torch.inference_mode()
    def _phase1(self, tokens: torch.Tensor, mask: torch.Tensor,
                s: torch.Tensor):
        """tokens (B, Tb) -> (t_en, d, durations (B, Tb) f32)."""
        pred = self.modules["predictor"]
        t_en = self.modules["text_encoder"](tokens, mask)
        d = pred.encode_duration(t_en, s, mask)
        duration = torch.sigmoid(pred.duration_head(d, mask)).sum(dim=-1)
        return t_en, d, torch.where(mask, duration,
                                    torch.zeros((), device=duration.device))

    @torch.inference_mode()
    def _phase2(self, t_en: torch.Tensor, d: torch.Tensor, s: torch.Tensor,
                durs: torch.Tensor, n_frames: int) -> torch.Tensor:
        """durations -> alignment -> F0/N -> decoder -> int16 PCM
        (B, 2 * n_frames * hop)."""
        align_t = ALN.build_alignment(durs, n_frames).transpose(1, 2)
        total = durs.sum(dim=1)
        frame_mask = (torch.arange(n_frames, device=durs.device)[None, :]
                      < total[:, None])
        mel_mask = torch.repeat_interleave(frame_mask, 2, dim=1)
        en = torch.matmul(align_t, d)
        f0, n_en = self.modules["predictor"].f0n(en, s, mask=frame_mask,
                                                 out_mask=mel_mask)
        asr = torch.matmul(align_t, t_en)
        dt = self.dtype
        wav = self.modules["decoder"](asr.to(dt), f0.float(), n_en.float(),
                                      s.to(dt), frame_mask)
        self.phase2_calls += 1
        pcm = torch.clamp(wav[..., 0].float(), -1.0, 1.0) * 32767.0
        return pcm.to(torch.int16)

    # ------------------------------------------------------------------
    # style computation
    # ------------------------------------------------------------------

    def compute_style(self, path_or_wave, denoise: float = 0.3,
                      split_dur: int = 3) -> torch.Tensor:
        """Reference clip (path or waveform) -> (1, style_dim) style: the
        mean over 3-s windows (plus a >= 1-s tail window) for clips of
        4 s or more, one whole-second window otherwise."""
        denoise = min(denoise, 1.0)
        if split_dur != 0:
            split_dur = max(int(split_dur), 1)
        sr = self.sr
        if isinstance(path_or_wave, str):
            wave, in_sr = AUD.read_wav(path_or_wave)
            wave = AUD.resample(wave, in_sr, sr)
        else:
            wave = np.asarray(path_or_wave, dtype=np.float32)
        audio, _ = AUD.trim_silence(wave, top_db=30)
        audio = audio[: sr * 20]  # cap 20 s
        if denoise > 0.0:
            audio = AUD.maybe_denoise(audio, sr, denoise)

        if split_dur > 0 and len(audio) / sr >= 4:
            jump = sr * split_dur
            n_full = len(audio) // jump
            chunks = audio[: n_full * jump].reshape(n_full, jump)
            ref_s = self._style(chunks).sum(dim=0, keepdim=True)
            count = n_full
            left = len(audio) - n_full * jump
            if left >= sr:  # a leftover of >= 1 s counts
                secs = left // sr
                tail = audio[n_full * jump: n_full * jump + secs * sr]
                ref_s = ref_s + self._style(tail[None])
                count += 1
            return ref_s / count
        secs = max(1, len(audio) // sr)
        return self._style(audio[: secs * sr][None])

    def get_styles(self, speaker: Dict[str, Any], denoise: float = 0.3,
                   avg_style: bool = True, load_styles: bool = False
                   ) -> Dict[str, Any]:
        if not load_styles:
            self.ref_s = self.compute_style(speaker["path"], denoise,
                                            3 if avg_style else 0)
        elif self.ref_s is None:
            raise RuntimeError("Have to compute or load the styles first!")
        return {"style": self.ref_s, "path": speaker.get("path"),
                "speed": speaker.get("speed", 1.0)}

    def save_styles(self, save_path: str) -> None:
        if self.ref_s is None:
            raise RuntimeError("Have to compute the styles before saving.")
        np.save(save_path, self.ref_s.cpu().numpy())

    def load_styles(self, save_path: str) -> None:
        self.ref_s = torch.as_tensor(np.load(save_path), dtype=torch.float32,
                                     device=self.device)

    # ------------------------------------------------------------------
    # synthesis
    # ------------------------------------------------------------------

    def _postprocess_durations(self, duration: np.ndarray, speed: float,
                               prev_d_mean: float, t: float,
                               rng: np.random.Generator
                               ) -> Tuple[np.ndarray, float]:
        """Host duration glue: fixed/scaled durations, stochastic rate
        stabilisation, outlier clamp, speed, rounding. Returns (pred_dur
        int32, the mean that chains into the next chunk)."""
        if self.fixed_duration is not None:
            duration = np.full(len(duration), float(self.fixed_duration),
                               np.float32)
            t = 0.0
        elif self.duration_scale is not None:
            duration = duration * self.duration_scale
        if t > 0:
            mean = prev_d_mean if prev_d_mean != 0 else duration.mean()
            dur_stats = rng.normal(mean, duration.std(), size=duration.shape)
            duration = duration * (1 - t) + dur_stats * t
        duration = np.array(duration)
        duration[1:-2] = _replace_outliers_zscore(duration[1:-2])
        duration = duration / min(max(speed, 1e-4), 2.0)
        new_d_mean = float(duration.mean())
        pred_dur = np.clip(np.round(duration), 1, None).astype(np.int32)
        # a single token longer than the largest bucket cannot be split at
        # a token boundary: clamp it (only absurd speeds reach this)
        pred_dur = np.minimum(pred_dur, self.cfg.tpu.frame_buckets[-1])
        return pred_dur, new_d_mean

    def _split_long(self, sentences: List[str]) -> List[str]:
        """Split (at word boundaries) any chunk whose tokens exceed the
        largest token bucket."""
        max_tokens = self.cfg.tpu.token_buckets[-1]
        work: List[str] = []
        for sentence in sentences:
            parts = [sentence]
            while parts:
                part = parts.pop(0)
                if (len(self.cleaner(part)) + 2 <= max_tokens
                        or len(part.split()) <= 1):
                    work.append(part)
                else:
                    words = part.split()
                    half = len(words) // 2
                    parts = [" ".join(words[:half]),
                             " ".join(words[half:])] + parts
        return work

    @torch.inference_mode()
    def _synthesize_chunks(self, sentences: List[str], ref_s, speed: float,
                           prev_d_mean: float, t: float, base_seed: int
                           ) -> Tuple[List[np.ndarray], List[float]]:
        """Chunk by chunk at batch 1: phase 1 on the token bucket, host
        duration glue on the chain stream default_rng([base_seed, 0]),
        phase 2 per span on its frame bucket. Returns each chunk's float
        waveform and duration mean."""
        s = (ref_s if isinstance(ref_s, torch.Tensor)
             else torch.tensor(np.asarray(ref_s))).to(
                 self.device, torch.float32).reshape(1, -1)
        rng = np.random.default_rng([base_seed, 0])
        fbs = self.cfg.tpu.frame_buckets
        wavs: List[np.ndarray] = []
        means: List[float] = []
        for sentence in self._split_long(sentences):
            tk = tokens_for_sentence(sentence, self.cleaner)
            tb = _bucket(self.cfg.tpu.token_buckets, len(tk))
            tokens = torch.zeros(1, tb, dtype=torch.int64)
            tokens[0, : len(tk)] = torch.as_tensor(tk)
            mask = torch.arange(tb)[None, :] < len(tk)
            t_en, d, dur = self._phase1(tokens.to(self.device),
                                        mask.to(self.device), s)
            duration = dur[0, : len(tk)].cpu().numpy()
            pred_dur, prev_d_mean = self._postprocess_durations(
                duration, speed, prev_d_mean, t, rng)
            means.append(prev_d_mean)
            segs = []
            for a, b in _split_spans(pred_dur, fbs[-1]):
                total = int(pred_dur[a:b].sum())
                durs = torch.zeros(1, tb, dtype=torch.int32)
                durs[0, : b - a] = torch.from_numpy(pred_dur[a:b])
                pad = (0, 0, 0, tb - (b - a))
                pcm = self._phase2(
                    torch.nn.functional.pad(t_en[:, a:b], pad),
                    torch.nn.functional.pad(d[:, a:b], pad), s,
                    durs.to(self.device), n_frames=_bucket(fbs, total))
                segs.append(pcm[0, : total * 2 * self.hop].cpu().numpy())
            wavs.append(np.concatenate(segs).astype(np.float32) / 32767.0)
        return wavs, means

    def generate(self, phonem: str, style: Dict[str, Any],
                 stabilize: bool = True, n_merge: int = 16) -> np.ndarray:
        """Long-form synthesis: sentence chunking, rate stabilisation,
        4000-sample edge trims and silence padding per chunk."""
        chunks = split_into_chunks(phonem, n_merge=n_merge)
        if not chunks:
            return np.zeros(8000, np.float32)
        # one seed draw per synthesis, as the JAX engine's plan makes
        base_seed = int(self._rng.integers(2 ** 63))
        wavs, _ = self._synthesize_chunks(chunks, style["style"],
                                          style.get("speed", 1.0), 0.0,
                                          0.2 if stabilize else 0.0,
                                          base_seed)
        out = np.concatenate([w[4000:-4000] for w in wavs])
        return np.concatenate([np.zeros(4000, np.float32), out,
                               np.zeros(4000, np.float32)])
