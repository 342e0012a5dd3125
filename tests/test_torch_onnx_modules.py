"""The exported graph against the port's own modules, and the export tool.

The graph from `export_modules` through the port's torch runtime (CPU)
against the same modules composed as tests/test_onnx.py::_jax_forward
composes the JAX package's (chip_smoke.onnx_reference, which phase 12 of
chip_smoke.py runs on the card): the three decoders on the JAX ONNX
suite's trees and inputs, gated as that suite gates its runtime against
its forward (equal lengths, max |got - want| / max |want| <= 5e-3). Then
`tools.export_onnx` with seeded random weights and with a reference-
layout .pth written by the port."""

import numpy as np
import pytest
import torch
import yaml

from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.checkpoint import load_checkpoint
from styletts2_tpu_torch.convert import save_torch_checkpoint
from styletts2_tpu_torch.models import build_inference_modules
from styletts2_tpu_torch.onnx import export_modules
from styletts2_tpu_torch.onnx.runtime import OnnxModel
from styletts2_tpu_torch.tools import export_onnx as TEO
from torch_onnx_common import (DECODERS, E2E_GATE, cfg_dict, inputs,
                               onnx_reference, port_cfg, port_modules,
                               scaled_max)

torch.set_num_threads(1)


@pytest.mark.parametrize("decoder", DECODERS)
def test_graph_matches_port_modules(decoder):
    mods = port_modules(decoder)
    feeds = inputs(decoder)
    got = OnnxModel(export_modules(mods, port_cfg(decoder)),
                    device="cpu").run(feeds)[0]
    want, _ = onnx_reference(mods, feeds)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = scaled_max(got, want)
    print(f"{decoder}: port runtime vs the composed port modules, "
          f"{len(got)} samples, scaled max {err:.3g}")
    assert err <= E2E_GATE


@pytest.fixture
def vocos_yaml(tmp_path):
    path = tmp_path / "vocos.yaml"
    path.write_text(yaml.safe_dump(cfg_dict("vocos")))
    return path


def test_tool_random_weights(vocos_yaml, tmp_path, capsys):
    out = tmp_path / "model.onnx"
    TEO.main(["--config", str(vocos_yaml), "--out", str(out), "--seed", "3"])
    assert "wrote" in capsys.readouterr().out
    data = out.read_bytes()
    out.unlink()
    # the seeded random modules the tool describes
    mods = build_inference_modules(port_cfg("vocos").model_params)
    W.init_random(mods, torch.Generator().manual_seed(3))
    assert data == export_modules(mods, port_cfg("vocos"))
    wav = OnnxModel(data, device="cpu").run(inputs("vocos"))[0]
    assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()


def test_tool_from_pth(vocos_yaml, tmp_path):
    """A reference-layout .pth (weight norm split; Vocos's decoder with the
    new-style keys, as tools/convert_to_torch writes it) of all four
    inference modules: the tool's file equals export_modules of the
    modules loaded from it."""
    mods = build_inference_modules(port_cfg("vocos").model_params)
    W.init_random(mods, torch.Generator().manual_seed(5))
    W.split_weight_norm(mods)
    pth = tmp_path / "model.pth"
    save_torch_checkpoint({k: W.module_tree(m) for k, m in mods.items()},
                          str(pth), new_style_modules=("decoder",))
    out = tmp_path / "model.onnx"
    TEO.main(["--config", str(vocos_yaml), "--checkpoint", str(pth),
              "--out", str(out)])
    data = out.read_bytes()
    out.unlink()
    loaded = build_inference_modules(port_cfg("vocos").model_params)
    W.load_param_tree(loaded, load_checkpoint(str(pth))["net"])
    pth.unlink()
    assert data == export_modules(loaded, port_cfg("vocos"))
    # and the weights are the checkpoint's, not the tool's seeded ones
    fresh = build_inference_modules(port_cfg("vocos").model_params)
    W.init_random(fresh, torch.Generator().manual_seed(0))
    assert data != export_modules(fresh, port_cfg("vocos"))
