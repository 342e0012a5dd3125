"""Where one `generate` call spends its time on the GPU.

    python -m styletts2_tpu_torch.profile_generate [--text TEXT] [--top N]

Builds the engine on the default config (bf16 decoder, seeded random
weights), warms it up, then traces one `generate` with torch.profiler and
prints the device time by kernel, the device busy time against the wall
time, and the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.infer import StyleTTS2

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config_example.yaml"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--text", default="Hello there, how are you today?")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_generate: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    engine = StyleTTS2(load_config(str(CONFIG)), seed=0)
    sr = engine.sr
    clip = (0.1 * np.random.default_rng(0).standard_normal(sr * 5)).astype(
        np.float32)
    style = {"style": engine.compute_style(clip)}
    for _ in range(2):  # warm-up: cuDNN plans, kernel loads
        engine.generate(args.text, style)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wav = engine.generate(args.text, style)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    print(f"card: {card}")
    print(f"generate: {len(wav) / sr:.2f} s audio, wall {wall * 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[: args.top]:
        print(f"{e.device_time_total / 1e3:9.3f} ms  {e.count:5d} x  "
              f"{e.key[:100]}")


if __name__ == "__main__":
    main()
