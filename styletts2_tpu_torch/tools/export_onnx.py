#!/usr/bin/env python
"""Export a checkpoint to ONNX (reference ONNX/export_onnx.py).
Counterpart of styletts2_tpu/tools/export_onnx.py, with the same flags.

    python -m styletts2_tpu_torch.tools.export_onnx --config config.yaml \
        [--checkpoint model.pth|model.ckpt] [--out model.onnx] [--seed N]

The modules start from seeded random weights (weights.init_random); a
checkpoint (a reference .pth, a port checkpoint or a JAX-written one:
checkpoint.load_checkpoint) replaces every module it holds. Without a
checkpoint the random weights are exported (graph-structure and shape
validation). The emitted graph takes (tokens int64 [T], style f32 [1,S],
speed f32 scalar) and returns the trimmed waveform — the same I/O
contract as the reference's model.onnx, so downstream onnxruntime
consumers (ONNX/inference_onnx.py, voicepack flows) work unchanged. The
export is host work: no GPU is needed.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="model.onnx")
    ap.add_argument("--seed", type=int, default=0,
                    help="init seed of the modules a checkpoint does not "
                    "hold (all of them without one)")
    args = ap.parse_args(argv)

    import torch

    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.models import build_inference_modules
    from styletts2_tpu_torch.onnx import export_modules

    cfg = load_config(args.config)
    mods = build_inference_modules(cfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(args.seed))
    if args.checkpoint:
        W.load_param_tree(mods, W.load_checkpoint_net(args.checkpoint))

    data = export_modules(mods, cfg, path=args.out)
    print(f"wrote {args.out} ({len(data) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
