"""Optimization: per-module AdamW + OneCycle, the MultiOptimizer equivalent.

Counterpart of styletts2_tpu/optim.py (reference optimizers.py:11-73 +
train.py:133-154). Each module gets its own torch.optim.AdamW (the
reference's own optimizer: lr 1e-4, betas (0, 0.99), eps 1e-9, weight
decay 1e-4); 'decoder' and 'style_encoder' run at ft_lr. torch's AdamW
decays the weight before the Adam step and optax's adds the decay to the
update; both give p - lr * (wd * p + m_hat / (sqrt(v_hat) + eps)). The
reference builds a OneCycleLR it never steps, constant in its config:
`onecycle_lr` gives the schedule, the optimizers run at constant lr.

States leave the port as numpy trees in the JAX param layout:
{module: {"count": int, "mu": tree, "nu": tree}} (Adam's first and second
moments under the parameters' own keys). They enter in that layout or in
the JAX package's: per module optax.adamw's chain state, a tuple whose
ScaleByAdamState holds the same count / mu / nu (read without optax
through checkpoint._Unpickler's stand-ins). The JAX package reads only
optax's objects, so it resumes a port checkpoint's weights and counters
with `load_only_params: true`, not its optimizer.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch
import torch.nn as nn

from styletts2_tpu_torch import weights as W

ACOUSTIC_MODULES = ("decoder", "style_encoder")  # ft_lr (train.py:147-154)


def onecycle_lr(step: int, max_lr: float, total_steps: int,
                pct_start: float = 0.0, div_factor: float = 1.0,
                final_div_factor: float = 1.0) -> float:
    """torch OneCycleLR(anneal='cos') as optax.cosine_onecycle_schedule
    computes it; max_lr throughout in the reference's config."""
    if div_factor == 1.0 and final_div_factor == 1.0 and pct_start == 0.0:
        return max_lr
    init = max_lr / div_factor
    end = max_lr / (div_factor * final_div_factor)
    b1 = int(pct_start * total_steps)

    def cos(start, stop, pct):
        return stop + (start - stop) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    if step < b1:
        return cos(init, max_lr, step / b1)
    if step < total_steps:
        return cos(max_lr, end, (step - b1) / (total_steps - b1))
    return end


def make_adamw(params: Iterable[nn.Parameter], lr: float,
               weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """AdamW(lr, betas=(0.0, 0.99), eps=1e-9, wd=1e-4) (optimizers.py:66)."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.0, 0.99), eps=1e-9,
                             weight_decay=weight_decay)


class MultiOptimizer:
    """One AdamW per module with its own step (reference
    optimizers.MultiOptimizer). lr 0 freezes a module: the decay is
    scaled by lr too."""

    def __init__(self, modules: Mapping[str, nn.Module], lr: float = 1e-4,
                 ft_lr: float = 1e-5):
        self.modules = modules
        self.opts: Dict[str, torch.optim.AdamW] = {
            key: make_adamw(mod.parameters(),
                            ft_lr if key in ACOUSTIC_MODULES else lr)
            for key, mod in modules.items()}

    def set_lr(self, key: str, lr: float) -> None:
        for group in self.opts[key].param_groups:
            group["lr"] = lr

    def step(self, key: str) -> None:
        """Apply the module's gradients, then clear them."""
        self.opts[key].step()
        self.opts[key].zero_grad(set_to_none=True)

    def state_trees(self) -> Dict[str, Any]:
        """{module: {"count", "mu", "nu"}} as numpy trees (see the module
        docstring); a module that has not stepped has count 0 and zero
        moments."""
        out = {}
        for key, mod in self.modules.items():
            opt = self.opts[key]
            mu, nu, count = {}, {}, 0
            for name, p in mod.named_parameters():
                st = opt.state.get(p, {})
                if st:
                    count = int(st["step"])
                for flat, k in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                    v = st.get(k)
                    flat[name] = (np.zeros(tuple(p.shape), np.float32)
                                  if v is None
                                  else v.detach().cpu().numpy().copy())
            out[key] = {"count": count, "mu": W.nest(mu), "nu": W.nest(nu)}
        return out

    def load_state_trees(self, trees: Mapping[str, Any]) -> None:
        """Restore per-module AdamW states (modules absent from `trees`
        keep a fresh state), from `state_trees`' layout or from a JAX
        checkpoint's optax chain state (see `adam_moments`): count ->
        step, mu -> exp_avg, nu -> exp_avg_sq, matched by the parameter's
        state-dict name. Every parameter must have its moments. A moment
        leaf that names no parameter (a buffer, e.g. BatchNorm's running
        stats, which torch's optimizer does not train) is dropped when it
        is zero and raises when it is not: it would be training state the
        port cannot carry."""
        for key, mod in self.modules.items():
            if key not in trees:
                continue
            count, mu_tree, nu_tree = adam_moments(trees[key])
            if count == 0:
                continue
            mu = W.tree_to_state_dict(mu_tree, fuse=False)
            nu = W.tree_to_state_dict(nu_tree, fuse=False)
            params = dict(mod.named_parameters())
            missing = sorted(set(params) - set(mu))
            if missing:
                raise KeyError(f"optimizer state of {key} has no moments "
                               f"for {missing}")
            for name in sorted(set(mu) - set(params)):
                if mu[name].any() or nu[name].any():
                    raise ValueError(
                        f"optimizer state of {key}: nonzero moments at "
                        f"{name}, which is not a parameter of the module")
            for name, p in params.items():
                self.opts[key].state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu[name].to(p.device),
                    "exp_avg_sq": nu[name].to(p.device)}


def adam_moments(state: Any):
    """(count, mu tree, nu tree) of one module's optimizer state: the port's
    {"count", "mu", "nu"} dict, or optax.adamw's chain state (a tuple whose
    one element with count / mu / nu is scale_by_adam's; the decay and lr
    stages hold nothing)."""
    if isinstance(state, Mapping):
        return int(state["count"]), state["mu"], state["nu"]
    if isinstance(state, (tuple, list)):
        adam = [s for s in state
                if all(hasattr(s, f) for f in ("count", "mu", "nu"))]
        if len(adam) == 1:
            s = adam[0]
            return int(np.asarray(s.count)), s.mu, s.nu
    raise TypeError(f"unknown optimizer state layout: {type(state).__name__}"
                    " (expected the port's {count, mu, nu} or optax.adamw's"
                    " chain state)")
