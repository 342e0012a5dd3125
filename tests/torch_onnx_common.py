"""Shared cases of tests/test_torch_onnx*.py: the JAX ONNX suite's small
configs, seeds and inputs (tests/test_onnx.py), the JAX package's numpy
trees for them (the three modules the graph holds, with build_model's
keys), and the port's modules loaded from those trees."""

import copy
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from styletts2_tpu.config import load_config as jax_load_config
from styletts2_tpu.nn import decoder as JDE
from styletts2_tpu.nn import predictor as JPR
from styletts2_tpu.nn import text_encoder as JTE
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.models import build_inference_modules
from test_onnx import SMALL_CFG

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402  (the composed forward, onnx_reference)

DECODERS = ("hifigan", "istftnet", "vocos")
# decoder -> (PRNGKey of its tree, seed of its tokens and style): the JAX
# suite's test_onnx_matches_jax_forward{,_istftnet,_vocos}
SEEDS = {"hifigan": (3, 7), "istftnet": (4, 9), "vocos": (5, 11)}
# the JAX suite's gate for its runtime against its forward: max |got -
# want| / max |want|
E2E_GATE = 5e-3


def cfg_dict(decoder):
    d = copy.deepcopy(SMALL_CFG)
    if decoder == "istftnet":
        d["model_params"]["decoder"] = {"type": "istftnet"}
    elif decoder == "vocos":
        d["model_params"]["decoder"] = {"type": "vocos", "num_layers": 3}
    return d


_TREES = {}


def jax_tree(decoder):
    """(numpy tree of text_encoder / predictor / decoder, JAX config):
    build_model(PRNGKey(seed))'s three modules (its keys[0..2]), without
    building the five others."""
    if decoder not in _TREES:
        cfg = jax_load_config(cfg_dict(decoder))
        a = cfg.model_params
        with jax.default_device(jax.devices("cpu")[0]):
            keys = jax.random.split(jax.random.PRNGKey(SEEDS[decoder][0]), 8)
            tree = {
                "decoder": JDE.decoder_init(keys[0], a.decoder,
                                            dim_in=a.hidden_dim,
                                            style_dim=a.style_dim),
                "predictor": JPR.init(keys[1], style_dim=a.style_dim,
                                      d_hid=a.hidden_dim, nlayers=a.n_layer,
                                      max_dur=a.max_dur),
                "text_encoder": JTE.init(keys[2], channels=a.hidden_dim,
                                         kernel_size=5, depth=a.n_layer,
                                         n_symbols=a.n_token)}
        _TREES[decoder] = ({k: jax.tree.map(np.asarray, v)
                            for k, v in tree.items()}, cfg)
    return _TREES[decoder]


def port_cfg(decoder):
    return load_config(cfg_dict(decoder))


def port_modules(decoder):
    """The port's inference modules with the JAX tree loaded (weight norm
    fused, the decoder prepacked in f32), in eval mode on the CPU."""
    mods = build_inference_modules(port_cfg(decoder).model_params)
    W.load_param_tree(mods, jax_tree(decoder)[0])
    return mods.eval()


def inputs(decoder, speed=1.0):
    """The JAX suite's tokens (16 ids) and style for `decoder`, as feeds."""
    rng = np.random.default_rng(SEEDS[decoder][1])
    tokens = rng.integers(1, 40, 16).astype(np.int64)
    style = rng.standard_normal((1, 32)).astype(np.float32)
    return {"tokens": tokens, "style": style, "speed": np.float32(speed)}


def scaled_max(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / (np.abs(np.asarray(want)).max() + 1e-6))


def onnx_reference(mods, feeds, device="cpu"):
    return CS.onnx_reference(mods, feeds["tokens"], feeds["style"],
                             float(feeds["speed"]), device=device,
                             dtype=torch.float32)
