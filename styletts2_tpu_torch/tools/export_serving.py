"""Voicepacks: precomputed style vectors plus the symbol table in one .npz
(reference ONNX/with_voicepacks.py). Counterpart of the voicepack half of
styletts2_tpu/tools/export_serving.py, in the same format, so each
package reads the other's packs:
  symbol_table: the symbol dict as a JSON string
  style/<name>: a (1, style_dim) float32 array per voice
The JAX tool's StableHLO graph export has no counterpart here.

Usage:
  python -m styletts2_tpu_torch.tools.export_serving \
      --config configs/config_example.yaml --ckpt model.pth \
      --voices-dir voices/ --out pack.npz
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict

import numpy as np


def save_voicepack(engine, out_path: str, voices: Dict[str, str],
                   denoise: float = 0.3) -> None:
    """Compute the style of each named reference clip (WAV or FLAC) and
    write them with the engine's symbol table."""
    styles = {name: engine.compute_style(path, denoise=denoise)
              .detach().cpu().numpy() for name, path in voices.items()}
    np.savez(out_path,
             symbol_table=json.dumps(engine.symbol_dict),
             **{f"style/{k}": v for k, v in styles.items()})
    print(f"voicepack with {len(styles)} voices -> {out_path}")


def load_voicepack(path: str):
    """-> (symbol table dict, {voice: style array})."""
    data = np.load(path, allow_pickle=False)
    symbol_table = json.loads(str(data["symbol_table"]))
    styles = {k.split("/", 1)[1]: data[k] for k in data.files
              if k.startswith("style/")}
    return symbol_table, styles


def voice_files(voices_dir: str) -> Dict[str, str]:
    """{file stem: path} of every .wav and .flac in a directory."""
    paths = sorted(glob.glob(os.path.join(voices_dir, "*.wav"))
                   + glob.glob(os.path.join(voices_dir, "*.flac")))
    return {os.path.splitext(os.path.basename(p))[0]: p for p in paths}


def main(argv=None) -> None:
    from styletts2_tpu_torch.infer import StyleTTS2

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--voices-dir", required=True)
    ap.add_argument("--denoise", type=float, default=0.3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = StyleTTS2(args.config, args.ckpt, device=args.device)
    save_voicepack(engine, args.out, voice_files(args.voices_dir),
                   denoise=args.denoise)


if __name__ == "__main__":
    main()
