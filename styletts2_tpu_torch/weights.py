"""Weights: carry the JAX package's parameter trees into the port's modules.

Counterpart of styletts2_tpu/convert.py for the port. A parameter tree is a
nested dict of arrays keyed by the reference torch module paths — the
output of styletts2_tpu.models.build_model after np.asarray, or the `net`
of a native `.ckpt` (a pickle of numpy trees). For inference, weight norm
(weight_g, weight_v) is fused into a plain `weight` here, once, on the
host; the flattened keys are then exactly the port's state-dict keys, and
every kernel-B1 conv weight is prepacked as the kernel takes it ((k, C_in,
C_out) in the decoder dtype). A training build keeps the pairs as
parameters (AdamW on g and v is not AdamW on the fused weight):
`split_weight_norm`, then `load_param_tree(..., fuse=False)`;
`module_tree` writes a module back as a numpy tree in the JAX layout.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn


def fuse_weight_norm(tree):
    """Merge every (weight_g, weight_v) pair into weight = g * v / ||v||
    (norm over all but dim 0, torch weight_norm(dim=0) parity), in numpy."""
    if not isinstance(tree, Mapping):
        return tree
    if "weight_v" in tree:
        v = np.asarray(tree["weight_v"], dtype=np.float32)
        g = np.asarray(tree["weight_g"], dtype=np.float32)
        norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)),
                              keepdims=True))
        fused = {"weight": g * v / norm}
        fused.update({k: val for k, val in tree.items()
                      if k not in ("weight_v", "weight_g")})
        return fused
    return {k: fuse_weight_norm(v) for k, v in tree.items()}


def tree_to_state_dict(tree: Mapping[str, Any],
                       fuse: bool = True) -> Dict[str, torch.Tensor]:
    """Nested param tree -> flat {dotted key: f32 tensor}, weight norm
    fused unless fuse=False."""
    flat: Dict[str, torch.Tensor] = {}

    def rec(node, prefix):
        if isinstance(node, Mapping):
            for k, v in node.items():
                rec(v, prefix + [str(k)])
        else:
            flat[".".join(prefix)] = torch.from_numpy(
                np.array(node, dtype=np.float32))

    rec(fuse_weight_norm(tree) if fuse else tree, [])
    return flat


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{dotted key: leaf} -> nested tree (the reverse of flattening)."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def module_tree(module: nn.Module) -> Dict[str, Any]:
    """A module's state dict as a nested numpy tree in the JAX layout
    (the reverse of tree_to_state_dict(fuse=False))."""
    return nest({k: v.detach().cpu().numpy().copy()
                 for k, v in module.state_dict().items()})


def split_weight_norm(root: nn.Module) -> None:
    """Turn every conv marked by `layers.wn` into a (weight_g, weight_v)
    pair with g = ||w|| (over all but dim 0) and v = w, so the fused
    weight is unchanged. A module already split is left as it is."""
    for m in root.modules():
        if not getattr(m, "weight_norm", False) or "weight" not in m._parameters:
            continue
        w = m.weight.detach()
        del m._parameters["weight"]
        norm = torch.sqrt(torch.sum(w * w, dim=tuple(range(1, w.dim())),
                                    keepdim=True))
        m.weight_g = nn.Parameter(norm.clone())
        m.weight_v = nn.Parameter(w.clone())


def load_param_tree(engine_or_modules, tree: Mapping[str, Any],
                    decoder_dtype: torch.dtype = torch.float32,
                    fuse: bool = True) -> None:
    """Load {module: tree} into the port's modules, strictly (every key and
    shape must match), then prepack the decoder's kernel-B1 weights in
    `decoder_dtype`. fuse=False: a training build (weight norm split, no
    prepacking).

    engine_or_modules: an infer.StyleTTS2 (its `.modules`) or a mapping of
    module name -> nn.Module. Modules absent from `tree` are left as they
    are; tree entries without a module (e.g. the training-only modules of
    a full checkpoint) are ignored."""
    modules = (engine_or_modules if hasattr(engine_or_modules, "items")
               else engine_or_modules.modules)
    for name, module in modules.items():
        if name not in tree:
            continue
        module.load_state_dict(tree_to_state_dict(tree[name], fuse),
                               strict=True)
        if fuse and hasattr(module, "prepack"):
            module.prepack(decoder_dtype)


def load_checkpoint_net(path: str) -> Dict[str, Any]:
    """The `net` ({module: numpy tree}) of a native `.ckpt` checkpoint.
    Unpickling runs code: load only checkpoints this project wrote."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    return state["net"]


def init_random(modules: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights with the JAX package's init distributions:
    U(+-1/sqrt(fan_in)) for convs, linears and their biases (fan_in of a
    transposed conv from its (in, out/g, k) weight's dims 1 and 2),
    U(+-1/sqrt(H)) for LSTMs, N(0, 1) embeddings, xavier-uniform for the
    duration projection; norms and Snake alphas keep their ones/zeros."""
    def uniform_(p, bound):
        with torch.no_grad():
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)

    for name, m in modules.named_modules():
        if "weight_v" in m._parameters:
            raise ValueError(f"init_random: {name} has its weight norm "
                             "split; initialise before split_weight_norm")
        if name.endswith("duration_proj.linear_layer"):
            out_dim, in_dim = m.weight.shape
            uniform_(m.weight, (6.0 / (in_dim + out_dim)) ** 0.5)
            with torch.no_grad():
                m.bias.zero_()
        elif isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d,
                            nn.Linear)):
            w = m.weight
            fan_in = int(np.prod(w.shape[1:]))
            bound = 1.0 / fan_in ** 0.5
            uniform_(w, bound)
            if m.bias is not None:
                uniform_(m.bias, bound)
        elif isinstance(m, (nn.LSTM, nn.LSTMCell)):
            for p in m.parameters():
                uniform_(p, 1.0 / m.hidden_size ** 0.5)
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator))
