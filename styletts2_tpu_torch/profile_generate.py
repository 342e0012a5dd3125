"""Where one `generate` call spends its time on the GPU, on both paths.

    python -m styletts2_tpu_torch.profile_generate [--text TEXT] [--top N]
        [--decoder hifigan|istftnet|vocos]

Builds the engine on the default config (bf16 decoder, seeded random
weights; --decoder changes its decoder type, config.with_decoder_type),
warms it up, then traces one `generate` with torch.profiler on
the fused path (a single-chunk text replays its CUDA graph) and one with
`fused_enabled = False` (the two-phase path, eager), and prints for each
the device time by kernel and the device busy time against the wall time,
with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from styletts2_tpu_torch.config import load_config, with_decoder_type
from styletts2_tpu_torch.infer import StyleTTS2
from styletts2_tpu_torch.profiling import card_line

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config_example.yaml"


def profile_one(engine: StyleTTS2, text: str, style, top: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # warm-up: cuDNN plans, kernel loads, graph capture
        engine.generate(text, style)
    torch.cuda.synchronize()
    replays = engine.graph_replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wav = engine.generate(text, style)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    path = ("fused graph" if engine.graph_replays > replays
            else "two-phase")
    print(f"{path}: {len(wav) / engine.sr:.2f} s audio, wall "
          f"{wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / (wall * 1e3):.1f}% of wall, idle "
          f"{100 - 100 * busy_ms / (wall * 1e3):.1f}%), "
          f"{sum(e.count for e in events)} device events")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:top]:
        print(f"{e.device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--text", default="Hello there, how are you today?")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--decoder", choices=("hifigan", "istftnet", "vocos"),
                    default="hifigan")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: no CUDA device")

    card = card_line()
    engine = StyleTTS2(load_config(with_decoder_type(
        yaml.safe_load(CONFIG.read_text()), args.decoder)), seed=0)
    sr = engine.sr
    clip = (0.1 * np.random.default_rng(0).standard_normal(sr * 5)).astype(
        np.float32)
    style = {"style": engine.compute_style(clip)}
    print(f"card: {card}; decoder {args.decoder}")
    for fused in (True, False):
        engine.fused_enabled = fused
        profile_one(engine, args.text, style, args.top)
    graphs = ", ".join(f"({tb}, {fb}): {g.peak_bytes / 2 ** 20:.1f} MiB"
                       for (tb, fb), g in sorted(engine.graphs.items()))
    print(f"fused graphs (token bucket, frame bucket): peak allocated while "
          f"capturing: {graphs}")


if __name__ == "__main__":
    main()
