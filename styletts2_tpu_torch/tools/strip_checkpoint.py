"""Strip a training checkpoint to the four inference modules (reference
Demo/del_training.ipynb: text_aligner, pitch_extractor, mpd, msd and the
optimizer state go). Counterpart of styletts2_tpu/tools/strip_checkpoint.py,
with the same flags; reads native checkpoints of either package and
reference .pth files, writes a native checkpoint.

Usage:
  python -m styletts2_tpu_torch.tools.strip_checkpoint --ckpt in.ckpt \
      --out out.ckpt
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from styletts2_tpu_torch.checkpoint import (load_checkpoint,
                                                save_checkpoint,
                                                strip_for_inference)

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    state = strip_for_inference(load_checkpoint(args.ckpt))
    save_checkpoint(args.out, state["net"], optimizer=None,
                    iters=state["iters"], epoch=state["epoch"])
    print(f"wrote inference-only checkpoint to {args.out} "
          f"({sorted(state['net'])})")


if __name__ == "__main__":
    main()
