"""Checkpoint I/O in the JAX package's native format.

Counterpart of styletts2_tpu/checkpoint.py: one pickle of
{"net": {module: numpy tree}, "optimizer", "iters", "epoch", "val_loss",
"format": "styletts2_tpu.v1"}, atomically replaced. The trees keep
`weight_g`/`weight_v`, so a checkpoint the port writes loads in
`styletts2_tpu.checkpoint.load_checkpoint` + `apply_checkpoint`, in the
port's inference engine (`weights.load_checkpoint_net`, which fuses the
pairs) and back into the port's trainer. The optimizer entry is the port's
own layout (optim.MultiOptimizer.state_trees). Unpickling runs code: load
only checkpoints this project wrote.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Mapping, Optional

import torch.nn as nn

from styletts2_tpu_torch import weights as W


def save_checkpoint(path: str, modules: Mapping[str, nn.Module],
                    optimizer: Optional[Any] = None, iters: int = 0,
                    epoch: int = 0, val_loss: float = 0.0) -> None:
    state = {
        "net": {k: W.module_tree(m) for k, m in modules.items()},
        "optimizer": optimizer,
        "iters": iters,
        "epoch": epoch,
        "val_loss": val_loss,
        "format": "styletts2_tpu.v1",
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A native checkpoint's state dict ({'net', 'optimizer', 'iters',
    'epoch', 'val_loss'}); reference .pth files are not read here."""
    if path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: reference .pth checkpoints are not "
                         "ported; convert with the JAX package first")
    with open(path, "rb") as f:
        return pickle.load(f)


def apply_checkpoint(modules: Mapping[str, nn.Module], state: Dict[str, Any],
                     ignore_modules=()) -> None:
    """Load every module of `state["net"]` into `modules` strictly (every
    key and shape), except those in ignore_modules, which keep their fresh
    weights (reference models.py:583-613)."""
    for key, mod in modules.items():
        if key in ignore_modules:
            print(f"{key} Ignored")
            continue
        if key not in state["net"]:
            continue
        mod.load_state_dict(W.tree_to_state_dict(state["net"][key],
                                                 fuse=False), strict=True)
        print(f"{key} Loaded")
