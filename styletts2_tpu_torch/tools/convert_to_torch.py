"""Write a checkpoint (native, or a .pth to re-save) as a reference-layout
.pth, the way back into the reference's own train.py / inference.py
(reference checkpoint layout train.py:349-357). Counterpart of
styletts2_tpu/tools/convert_to_torch.py, with the same flags.

Usage:
  python -m styletts2_tpu_torch.tools.convert_to_torch \
      --checkpoint current_model.ckpt --config config.yaml --out model.pth
      [--strip]   # the four inference modules only
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from styletts2_tpu_torch.checkpoint import (load_checkpoint,
                                                strip_for_inference)
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.convert import save_torch_checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="native checkpoint (or a .pth to re-save)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--strip", action="store_true",
                    help="keep only the 4 inference modules")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    state = load_checkpoint(args.checkpoint)
    if args.strip:
        state = strip_for_inference(state)
    new_style = (("decoder",)
                 if cfg.model_params.decoder.type == "vocos" else ())
    save_torch_checkpoint(state["net"], args.out,
                          iters=state.get("iters", 0),
                          epoch=state.get("epoch", 0),
                          val_loss=state.get("val_loss", 0.0),
                          new_style_modules=new_style)
    print(f"wrote {args.out} ({len(state['net'])} modules, "
          f"iters {state.get('iters', 0)})")


if __name__ == "__main__":
    main()
