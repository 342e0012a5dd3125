"""Checkpoint I/O: the JAX package's native format and reference .pth files.

Counterpart of styletts2_tpu/checkpoint.py. A native checkpoint is one
pickle of {"net": {module: numpy tree}, "optimizer", "iters", "epoch",
"val_loss", "format": "styletts2_tpu.v1"}, atomically replaced. The trees
keep `weight_g`/`weight_v`, so a checkpoint the port writes loads in
`styletts2_tpu.checkpoint.load_checkpoint` + `apply_checkpoint`, in the
port's inference engine (`weights.load_checkpoint_net`, which fuses the
pairs) and back into the port's trainer. A reference .pth (detected by
suffix or by zip / protocol-2 pickle magic) loads through
`convert.load_torch_checkpoint`, with no optimizer state.

The optimizer entry the port writes is its own layout
(optim.MultiOptimizer.state_trees). One the JAX package wrote holds
optax's state objects; they are read here with no optax or jax import:
`_Unpickler` maps optax's AdamW chain states, by class name, to the plain
namedtuples below, which optim.MultiOptimizer.load_state_trees accepts.
Any other optax or jax class raises, naming it. Unpickling runs code:
load only checkpoints this project wrote.
"""

from __future__ import annotations

import collections
import os
import pickle
from typing import Any, Dict, Mapping, Optional

import torch.nn as nn

from styletts2_tpu_torch import weights as W

# stand-ins for what optax.adamw with a float learning rate puts in its
# chain: scale_by_adam's state, then add_decayed_weights' and the lr
# scale's, which are EmptyState in current optax and named empty states in
# older ones. Keyed by class name: optax moves them between modules.
ScaleByAdamState = collections.namedtuple("ScaleByAdamState",
                                          ["count", "mu", "nu"])
EmptyState = collections.namedtuple("EmptyState", [])
_OPTAX_STANDINS = {"ScaleByAdamState": ScaleByAdamState,
                   "EmptyState": EmptyState,
                   "AddDecayedWeightsState": EmptyState,
                   "ScaleState": EmptyState}


class _Unpickler(pickle.Unpickler):
    """pickle.Unpickler that reads optax's AdamW states into the stand-ins
    and refuses every other class of optax or jax."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "optax" and name in _OPTAX_STANDINS:
            return _OPTAX_STANDINS[name]
        if root in ("optax", "jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(
                f"checkpoint holds {module}.{name}, which the port cannot "
                f"read without {root} (it maps only optax's AdamW states: "
                f"{sorted(_OPTAX_STANDINS)})")
        return super().find_class(module, name)


def save_checkpoint(path: str, modules: Mapping[str, Any],
                    optimizer: Optional[Any] = None, iters: int = 0,
                    epoch: int = 0, val_loss: float = 0.0) -> None:
    """modules: {name: nn.Module or numpy tree} (a tree is written as it
    is, as the checkpoint tools do)."""
    state = {
        "net": {k: W.module_tree(m) if isinstance(m, nn.Module) else m
                for k, m in modules.items()},
        "optimizer": optimizer,
        "iters": iters,
        "epoch": epoch,
        "val_loss": val_loss,
        "format": "styletts2_tpu.v1",
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic: a crash leaves the old file


def _is_torch_checkpoint(path: str) -> bool:
    if path.endswith((".pth", ".pt")):
        return True
    with open(path, "rb") as f:
        magic = f.read(4)
    return magic[:2] == b"PK" or magic == b"\x80\x02"  # zipfile / old pickle


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A native checkpoint or a reference .pth -> {'net': {module: numpy
    tree}, 'optimizer', 'iters', 'epoch', 'val_loss'} ('optimizer' None,
    the counters 0 for a .pth, as the JAX package returns them)."""
    if _is_torch_checkpoint(path):
        from styletts2_tpu_torch.convert import load_torch_checkpoint

        return {"net": load_torch_checkpoint(path), "optimizer": None,
                "iters": 0, "epoch": 0, "val_loss": 0.0}
    with open(path, "rb") as f:
        return _Unpickler(f).load()


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


def strip_for_inference(state: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the four inference modules and drop the optimizer
    (reference Demo/del_training.ipynb)."""
    keep = ("decoder", "predictor", "text_encoder", "style_encoder")
    return {"net": {k: state["net"][k] for k in keep if k in state["net"]},
            "optimizer": None, "iters": state.get("iters", 0),
            "epoch": state.get("epoch", 0),
            "val_loss": state.get("val_loss", 0.0)}
