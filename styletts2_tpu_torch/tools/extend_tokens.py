"""Grow the vocabulary of a trained checkpoint (reference
Extend/extend.ipynb): four weight tensors get n_new rows drawn from
N(0, 0.01), in this order from one numpy generator:
  text_encoder.embedding.weight
  text_aligner.ctc_linear.2.linear_layer.{weight, bias}
  text_aligner.asr_s2s.embedding.weight
  text_aligner.asr_s2s.project_to_n_symbols.{weight, bias}
Counterpart of styletts2_tpu/tools/extend_tokens.py: the same flags and
the same draws, so a seed gives the rows the JAX tool gives.

Usage:
  python -m styletts2_tpu_torch.tools.extend_tokens \
      --ckpt current_model.ckpt --out extended.ckpt --new-tokens 11
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np


def _extend_rows(w, n_new: int, rng: np.random.Generator,
                 std: float = 0.01) -> np.ndarray:
    w = np.asarray(w)
    extra = rng.normal(0.0, std, (n_new,) + w.shape[1:]).astype(w.dtype)
    return np.concatenate([w, extra], axis=0)


def extend_token_set(net: Dict[str, Any], n_new: int,
                     seed: int = 0) -> Dict[str, Any]:
    """A new net dict with n_new extra token rows (`net` is not changed)."""
    rng = np.random.default_rng(seed)
    net = {k: dict(v) for k, v in net.items()}

    te = net["text_encoder"]
    te["embedding"] = {"weight": _extend_rows(te["embedding"]["weight"],
                                              n_new, rng)}

    ta = net["text_aligner"]
    ctc2 = dict(ta["ctc_linear"]["2"]["linear_layer"])
    ctc2["weight"] = _extend_rows(ctc2["weight"], n_new, rng)
    if "bias" in ctc2:
        ctc2["bias"] = _extend_rows(ctc2["bias"], n_new, rng)
    ta["ctc_linear"] = {**ta["ctc_linear"], "2": {"linear_layer": ctc2}}

    s2s = dict(ta["asr_s2s"])
    s2s["embedding"] = {"weight": _extend_rows(s2s["embedding"]["weight"],
                                               n_new, rng)}
    proj = dict(s2s["project_to_n_symbols"])
    proj["weight"] = _extend_rows(proj["weight"], n_new, rng)
    if "bias" in proj:
        proj["bias"] = _extend_rows(proj["bias"], n_new, rng)
    s2s["project_to_n_symbols"] = proj
    ta["asr_s2s"] = s2s
    return net


def main(argv=None) -> None:
    from styletts2_tpu_torch.checkpoint import load_checkpoint, save_checkpoint

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--new-tokens", type=int, required=True,
                    help="number of NEW symbols being added to the config's "
                         "symbol.extend string")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    state = load_checkpoint(args.ckpt)
    old_n = state["net"]["text_encoder"]["embedding"]["weight"].shape[0]
    net = extend_token_set(state["net"], args.new_tokens, args.seed)
    save_checkpoint(args.out, net, optimizer=None,
                    iters=state.get("iters", 0), epoch=state.get("epoch", 0))
    print(f"extended n_token {old_n} -> {old_n + args.new_tokens}; "
          f"wrote {args.out}")


if __name__ == "__main__":
    main()
