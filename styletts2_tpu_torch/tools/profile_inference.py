"""Per-phase, per-bucket inference profile of the engine on one device
(counterpart of styletts2_tpu/tools/profile_inference.py).

Times (median of reps, after a warm call; each call synchronised):
  * the dispatch floor: one trivial launch (x + 1 on an (8, 128) tensor)
    and one call of kernel B1's operator at HiFi-GAN's smallest stage shape
    (C 256 at the first stage of the smallest frame bucket): the port's
    host cost per kernel call
  * phase 1 (text encoder + duration) at token bucket 64, 50 real tokens
  * phase 2 (alignment + F0/N + decoder) at frame buckets 400, 800 and
    1600, every token fb // 64 frames, with its x realtime
  * the decoder alone, the HiFi-GAN generator alone and F0/N alone at
    frame bucket 800 on fabricated inputs

Run:  python -m styletts2_tpu_torch.tools.profile_inference
          [hifigan|istftnet|vocos] [batch] [--device cuda]

The batch argument (default 1) profiles the serving shapes: phase 1,
phase 2, the decoder and F0/N at batch N. Kernel B1 runs in every phase-2,
decoder and generator call (96 launches per HiFi-GAN evaluation, 48 with
iSTFTNet, none with Vocos); B2 in `compute_style`.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from styletts2_tpu_torch.config import Config, load_config
from styletts2_tpu_torch.profiling import card_line


def profile_config(decoder: str = "hifigan") -> Config:
    """The JAX tool's config: the decoder type, a bf16 decoder."""
    return load_config({
        "model_params": {"decoder": {"type": decoder}},
        "tpu": {"decoder_dtype": "bfloat16"},
        "debug": False,
    })


def med_time(fn: Callable[[], Any], dev: torch.device, reps: int = 10
             ) -> float:
    """Median seconds of `reps` calls, each synchronised."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _b1_operands(c: int, t: int, dtype, dev):
    """Random operands of one B1 operator call (k 3, d 1, a residual and
    the next AdaIN's statistics)."""
    gen = torch.Generator().manual_seed(13)

    def rnd(*shape, sc=1.0):
        return (torch.randn(*shape, generator=gen) * sc).to(dev)

    return (rnd(1, t, c).to(dtype), rnd(1, c, sc=0.5) + 1.0,
            rnd(1, c, sc=0.1), rnd(c).abs() + 0.5,
            rnd(3, c, c, sc=0.05).to(dtype), rnd(c, sc=0.01), 1,
            torch.tensor([t], dtype=torch.int32, device=dev),
            rnd(1, t, c).to(dtype), True)


def profile(cfg: Config, device="cuda", batch: int = 1, *,
            token_bucket: int = 64, n_tokens: int = 50,
            frame_buckets: Sequence[int] = (400, 800, 1600),
            decode_bucket: int = 800, style_seconds: float = 6.0,
            reps: int = 10, dispatch_reps: int = 30,
            log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Time each part of inference on `cfg`'s engine (seeded random
    weights, seed 0) and return the figures: seconds per call under `*_s`
    (`phase2_s` by frame bucket) and the calls made (`evals`: phase-2,
    decoder and generator evaluations, each one run of B1's blocks;
    `b1_op_calls`). Each figure's line goes to `log` as it is measured.
    device: "cuda" (raises when no GPU is present) or "cpu", which must
    be asked for."""
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.ops import vocoder_kernel as VK

    engine = StyleTTS2(cfg, seed=0, device=device)
    dev = engine.device
    mp = cfg.model_params
    b, tb, dt = batch, token_bucket, engine.dtype
    out: Dict[str, Any] = {"card": (card_line(dev.index or 0)
                                    if dev.type == "cuda" else "cpu"),
                           "batch": b, "evals": 0, "b1_op_calls": 0}
    log(out["card"])
    log("device: " + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"))

    def timed(key: str, fn: Callable[[], Any], n: int = reps,
              evals: int = 0) -> float:
        """One warm call, then the median of n synchronised calls."""
        fn()
        out[key] = med_time(fn, dev, n)
        out["evals"] += evals * (n + 1)
        return out[key]

    rng = np.random.default_rng(0)
    ref_wav = (rng.standard_normal(int(engine.sr * style_seconds)) * 0.1
               ).astype(np.float32)
    s = engine.compute_style(ref_wav, denoise=0.0)

    xsmall = torch.zeros(8, 128, device=dev)
    t = timed("dispatch_s", lambda: xsmall + 1.0, dispatch_reps)
    log(f"dispatch overhead: {t * 1e3:.2f} ms")
    t_b1 = 2 * min(cfg.tpu.frame_buckets) * 10
    b1_args = _b1_operands(256, t_b1, dt, dev)
    with torch.inference_mode():
        t = timed("b1_op_s", lambda: VK.OP(*b1_args), dispatch_reps)
    out["b1_op_calls"] = dispatch_reps + 1
    log(f"B1 op call (1, {t_b1}, 256): {t * 1e3:.3f} ms")

    sB = s.expand(b, -1).contiguous()
    tokens = torch.zeros(b, tb, dtype=torch.int64)
    tokens[:, :n_tokens] = torch.from_numpy(
        rng.integers(4, 170, (b, n_tokens)))
    mask = torch.zeros(b, tb, dtype=torch.bool)
    mask[:, :n_tokens] = True
    tokens, mask = tokens.to(dev), mask.to(dev)
    t_en, d, _ = engine._phase1(tokens, mask, sB)
    t = timed("phase1_s", lambda: engine._phase1(tokens, mask, sB))
    log(f"phase1 (b={b}, tb={tb}): {t * 1e3:.2f} ms")

    out["phase2_s"] = {}
    for fb in frame_buckets:
        durs = torch.full((b, tb), fb // tb, dtype=torch.int32, device=dev)

        def phase2():
            return engine._phase2(t_en, d, sB, durs, fb)

        phase2()
        t = out["phase2_s"][fb] = med_time(phase2, dev, reps)
        out["evals"] += reps + 1
        audio_s = b * fb * 2 * engine.hop / engine.sr
        log(f"phase2 (b={b}, fb={fb}, {audio_s:.1f}s audio): "
            f"{t * 1e3:.2f} ms -> {audio_s / t:.1f}x realtime")

    # the decoder alone on fabricated inputs
    fb = decode_bucket
    mel_t = fb * 2
    audio_s = b * fb * 2 * engine.hop / engine.sr

    def fab(*shape, dtype=torch.float32, fn=lambda a: a):
        return torch.from_numpy(fn(rng.standard_normal(shape))).to(
            device=dev, dtype=dtype)

    asr = fab(b, fb, mp.hidden_dim, dtype=dt)
    f0 = fab(b, mel_t, fn=lambda a: np.abs(a) * 100)
    n_en = fab(b, mel_t, fn=np.abs)
    frame_mask = torch.ones(b, fb, dtype=torch.bool, device=dev)
    with torch.inference_mode():
        t = timed("decoder_s", lambda: engine._decode(asr, f0, n_en, sB,
                                                      frame_mask), evals=1)
    log(f"decoder-only (b={b}, fb={fb}): {t * 1e3:.2f} ms "
        f"-> {audio_s / t:.1f}x")

    # the generator alone (the shell skipped): x at mel rate, 512 channels,
    # every frame valid (B1's route)
    if mp.decoder.type == "hifigan":
        x = fab(b, mel_t, 512, dtype=dt)
        mel_mask = torch.ones(b, mel_t, dtype=torch.bool, device=dev)
        generator = engine.modules["decoder"].generator
        with torch.inference_mode():
            t = timed("generator_s", lambda: generator(x, sB.to(dt), f0,
                                                       mel_mask), evals=1)
        log(f"generator-only: {t * 1e3:.2f} ms -> {audio_s / t:.1f}x")

    # F0/N alone
    en = fab(b, fb, mp.hidden_dim + mp.style_dim)
    out_mask = torch.ones(b, mel_t, dtype=torch.bool, device=dev)
    predictor = engine.modules["predictor"]
    with torch.inference_mode():
        t = timed("f0n_s", lambda: predictor.f0n(en, sB, mask=frame_mask,
                                                 out_mask=out_mask))
    log(f"f0n-only (b={b}, fb={fb}): {t * 1e3:.2f} ms")
    return out


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("decoder", nargs="?", default="hifigan",
                    choices=("hifigan", "istftnet", "vocos"))
    ap.add_argument("batch", nargs="?", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return profile(profile_config(args.decoder), args.device, args.batch,
                   log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
