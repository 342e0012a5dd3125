"""Reference PyTorch checkpoints (.pth) in and out of the port's trees.

Counterpart of styletts2_tpu/convert.py. A tree mirrors a module's state
dict paths ('generator.resblocks.3.convs1.0.weight_v' ->
tree['generator']['resblocks']['3']['convs1']['0']['weight_v']), with
numpy leaves, as the port's native trees (weights.module_tree) have. The
reference's quirks are handled as the JAX converter handles them:
* DataParallel 'module.' prefixes (reference models.py:578-612) are
  stripped;
* new-style weight norm ('<mod>.parametrizations.weight.original0/1',
  the Vocos decoder's, reference vocos.py:10) becomes weight_g / weight_v,
  and back with `new_style_weight_norm`;
* BatchNorm 'num_batches_tracked' is dropped on the way in and written as
  0 on the way out, so the reference's strict load accepts the file.

`load_torch_checkpoint` calls torch.load with weights_only=False, as the
JAX converter does (torch >= 2.6 defaults to weights_only=True, which
refuses the reference's pickled state). That unpickles, and so runs, code
from the file: load only trusted checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DROP_LEAVES = {"num_batches_tracked"}


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value)


def state_dict_to_tree(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat torch state dict (str -> tensor or array) -> nested dict of
    numpy arrays keyed by the module path's components."""
    tree: Dict[str, Any] = {}
    for key, value in sd.items():
        parts = key.split(".")
        if parts[0] == "module":  # DataParallel prefix
            parts = parts[1:]
        if (len(parts) >= 3 and parts[-3] == "parametrizations"
                and parts[-2] == "weight"):
            leaf = {"original0": "weight_g", "original1": "weight_v"}[parts[-1]]
            parts = parts[:-3] + [leaf]
        if parts[-1] in _DROP_LEAVES:
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _numpy(value)
    return tree


def load_torch_checkpoint(path: str) -> Dict[str, Dict[str, Any]]:
    """A reference .pth training checkpoint (state['net'][module], reference
    train.py:349-357, or a bare {module: state dict}) -> {module: tree}.
    Unpickles: load only trusted files."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    net = state.get("net", state)
    return {key: state_dict_to_tree(sd) for key, sd in net.items()
            if isinstance(sd, Mapping)}


def module_to_tree(torch_module: torch.nn.Module) -> Dict[str, Any]:
    """A live module's state dict as a tree."""
    return state_dict_to_tree(torch_module.state_dict())


def tree_to_state_dict(tree: Mapping[str, Any],
                       new_style_weight_norm: bool = False
                       ) -> Dict[str, np.ndarray]:
    """Reverse of state_dict_to_tree: tree -> flat {dotted key: numpy}.
    new_style_weight_norm writes weight_g / weight_v as
    '<mod>.parametrizations.weight.original0/1' (the reference Vocos
    decoder's keys). 'num_batches_tracked' is written as 0 wherever a
    node has running stats."""
    flat: Dict[str, np.ndarray] = {}

    def rec(node, parts):
        if isinstance(node, Mapping):
            for k, v in node.items():
                rec(v, parts + [str(k)])
            if ("running_mean" in node and "running_var" in node
                    and "num_batches_tracked" not in node):
                flat[".".join(parts + ["num_batches_tracked"])] = \
                    np.asarray(0, np.int64)
            return
        leaf = parts[-1]
        if new_style_weight_norm and leaf in ("weight_g", "weight_v"):
            orig = {"weight_g": "original0", "weight_v": "original1"}[leaf]
            key = ".".join(parts[:-1] + ["parametrizations", "weight", orig])
        else:
            key = ".".join(parts)
        flat[key] = np.asarray(node)

    rec(tree, [])
    return flat


def save_torch_checkpoint(net: Mapping[str, Mapping[str, Any]], path: str,
                          iters: int = 0, epoch: int = 0,
                          val_loss: float = 0.0,
                          new_style_modules=()) -> None:
    """Write a reference-layout .pth (state['net'][module] flat state dicts,
    an empty 'optimizer', iters / epoch / val_loss; reference
    train.py:349-357) from {module: tree}. new_style_modules: the modules
    whose weight-norm leaves take the parametrizations keys (the 'decoder'
    of a Vocos config)."""
    state = {
        "net": {
            key: {k: torch.from_numpy(np.array(v))
                  for k, v in tree_to_state_dict(
                      tree, new_style_weight_norm=key in new_style_modules
                  ).items()}
            for key, tree in net.items()
        },
        "optimizer": {},
        "iters": iters,
        "epoch": epoch,
        "val_loss": val_loss,
    }
    torch.save(state, path)
