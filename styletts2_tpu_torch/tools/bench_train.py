"""Training-step throughput on one device (counterpart of
styletts2_tpu/tools/bench_train.py).

Times the production alternating D/G update (`train.make_train_step`,
the step `train_loop` runs: the D step, then the G step from the
generator state the D step started from) at the reference
train recipe (batch_size 5, max_len 300 mel frames) with seeded random
weights, per-module AdamW and a synthetic batch, and prints one JSON line:
ms per step, steps/s, mel frames/s, seconds of audio per second of
training, the first step's wall, the device, the last step's losses and
the peak memory allocated. f32 with TF32 off, as `train_loop` runs.
Kernel B2 runs 8 times per micro-batch (`compute_mels` in the D and the G
step, 6 in the MRSTFT loss); B1 is inference only and does not run.

Usage:
    python -m styletts2_tpu_torch.tools.bench_train [--batch 5]
        [--max-len 300] [--t-text 120] [--steps 10] [--decoder hifigan]
        [--remat] [--grad-accum N] [--device cuda]

The run is synchronised only at the two ends of the timed steps. An
out-of-memory error is raised, not caught: the batch is never shrunk.
"""

from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace
from typing import Any, Dict, Optional

import numpy as np
import torch

from styletts2_tpu_torch.config import Config, load_config

# kernel B2 launches per micro-batch of a D/G step: compute_mels in D and
# in G, and the 6 mel transforms of the MRSTFT loss (outside the remat
# region, so remat adds none)
B2_PER_MICRO_BATCH = 8


def bench_config(batch: int = 5, max_len: int = 300,
                 decoder: str = "hifigan", remat: bool = False,
                 grad_accum: int = 1) -> Config:
    """The full-width default config with the tool's overrides (the JAX
    tool's load_config dict)."""
    return load_config({
        "max_len": max_len,
        "batch_size": batch,
        "model_params": {"decoder": {"type": decoder}},
        "tpu": {"remat": remat, "grad_accum": grad_accum},
    })


def synthetic_batch(b: int, t_text: int, t_mel: int, hop: int = 300
                    ) -> Dict[str, np.ndarray]:
    """The JAX tool's batch: numpy's default_rng(0), waves first, full
    lengths; `hop` samples per mel frame (the JAX tool's 300, the default
    config's hop)."""
    rng = np.random.default_rng(0)
    return {
        "waves": rng.standard_normal((b, t_mel * hop)).astype("float32") * 0.1,
        "texts": rng.integers(4, 170, (b, t_text)).astype("int32"),
        "input_lengths": np.full((b,), t_text, np.int32),
        "mel_lengths": np.full((b,), t_mel, np.int32),
    }


def b2_launches(cfg: Config, steps: int) -> int:
    """Kernel B2 launches of the warm step and `steps` timed steps."""
    return B2_PER_MICRO_BATCH * cfg.tpu.grad_accum * (steps + 1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: Config, device="cuda", steps: int = 10, t_text: int = 120
        ) -> Dict[str, Any]:
    """One warm D/G step, then `steps` timed ones, on `cfg`'s batch_size x
    max_len synthetic batch; returns the JSON line's fields. device:
    "cuda" (raises when no GPU is present) or "cpu", which must be asked
    for. Errors, out-of-memory among them, propagate."""
    from styletts2_tpu_torch import train as TT
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.models import build_model
    from styletts2_tpu_torch.optim import MultiOptimizer

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_train: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # the modules as train_loop builds them, seeded random weights in place
    # of the pretrained checkpoint
    mods = build_model(cfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(0))
    W.split_weight_norm(mods)
    mods.to(dev).train()
    mods["pitch_extractor"].eval().requires_grad_(False)
    opt = MultiOptimizer(mods, lr=cfg.optimizer_params.lr,
                         ft_lr=cfg.optimizer_params.ft_lr)

    b, t_mel = cfg.batch_size, cfg.max_len
    hop = cfg.preprocess_params.spect_params.hop_length
    frames_per_s = cfg.preprocess_params.sr / hop  # 80 at the recipe
    nb = synthetic_batch(b, t_text, t_mel, hop)
    batch = TT.Batch.from_numpy(SimpleNamespace(**nb), dev)
    step = TT.make_train_step(cfg, opt)
    gen = torch.Generator(device=dev).manual_seed(1)

    t0 = time.perf_counter()
    step(mods, batch, gen)
    _sync(dev)
    first_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(mods, batch, gen)
    _sync(dev)
    wall = time.perf_counter() - t0

    decoder = cfg.model_params.decoder.type
    accum = cfg.tpu.grad_accum
    return {
        "metric": f"train step ({decoder}, batch {b}, max_len {t_mel}"
                  + (", remat" if cfg.tpu.remat else "")
                  + (f", accum {accum}" if accum > 1 else "") + ")",
        "ms_per_step": round(1000.0 * wall / steps, 2),
        "steps_per_s": round(steps / wall, 3),
        "mel_frames_per_s": round(b * t_mel * steps / wall, 1),
        "audio_s_per_train_s": round(b * t_mel * steps / frames_per_s
                                     / wall, 2),
        "compile_plus_first_step_s": round(first_s, 1),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "losses": {k: round(float(v), 4) for k, v in metrics.items()},
        "peak_mem_gib": (round(torch.cuda.max_memory_allocated(dev) / 2**30,
                               2) if dev.type == "cuda" else None),
    }


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--max-len", type=int, default=300,
                    help="mel frames per sample (reference max_len)")
    ap.add_argument("--t-text", type=int, default=120,
                    help="tokens per sample")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--decoder", default="hifigan",
                    choices=("hifigan", "istftnet", "vocos"))
    ap.add_argument("--remat", action="store_true",
                    help="tpu.remat: recompute the decoder synthesis and "
                    "the G-side discriminator forwards in the backward")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="tpu.grad_accum: micro-batches per optimizer "
                    "update (batch must divide)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = bench_config(args.batch, args.max_len, args.decoder, args.remat,
                       args.grad_accum)
    out = run(cfg, args.device, steps=args.steps, t_text=args.t_text)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
