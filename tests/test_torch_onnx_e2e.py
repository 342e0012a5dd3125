"""The exported graph end to end on the CPU: the port's export through the
port's torch runtime against the JAX package's export through its numpy
runtime (styletts2_tpu.onnx.runtime), for the three decoders on the JAX
ONNX suite's trees, tokens and styles (tests/test_onnx.py, which holds
that runtime against the JAX forward), and the speed input.

Gate: equal lengths and max |got - want| / max |want| <= 5e-3, the JAX
suite's own gate for its runtime against its forward."""

import contextlib

import numpy as np
import pytest
import torch

try:  # not a declared dependency: without it the BLAS keeps its threads
    from threadpoolctl import threadpool_limits
except ImportError:
    def threadpool_limits(*a, **k):
        return contextlib.nullcontext()

from styletts2_tpu.onnx import export_onnx as jax_export_onnx
from styletts2_tpu.onnx.runtime import OnnxModel as JaxOnnxModel
from styletts2_tpu_torch.onnx import export_onnx
from styletts2_tpu_torch.onnx.runtime import OnnxModel
from torch_onnx_common import (DECODERS, E2E_GATE, inputs, jax_tree,
                               port_cfg, scaled_max)

torch.set_num_threads(1)

_MODELS = {}


def port_model(decoder):
    if decoder not in _MODELS:
        tree, _ = jax_tree(decoder)
        _MODELS[decoder] = OnnxModel(export_onnx(tree, port_cfg(decoder)),
                                     device="cpu")
    return _MODELS[decoder]


@pytest.mark.parametrize("decoder", DECODERS)
def test_graph_matches_jax_runtime(decoder):
    tree, cfg = jax_tree(decoder)
    feeds = inputs(decoder)
    # the numpy runtime's products on one BLAS thread: OpenBLAS's idle
    # threads spin, which cost 2.5x this file's CPU time on a shared host
    with threadpool_limits(1, user_api="blas"):
        want = JaxOnnxModel(jax_export_onnx(tree, cfg)).run(feeds)[0]
    got = port_model(decoder).run(feeds)[0]
    assert got.dtype == np.float32 and got.shape == want.shape, (
        got.shape, want.shape)
    err = scaled_max(got, want)
    print(f"{decoder}: port runtime vs numpy runtime, {len(got)} samples, "
          f"scaled max {err:.3g}")
    assert err <= E2E_GATE


def test_speed_scales_duration():
    """Speed 0.5 gives a longer waveform than 1.5 (tests/test_onnx.py's
    check; the cheapest graph, Vocos: the duration path is the same for
    every decoder)."""
    model = port_model("vocos")
    slow = model.run(inputs("vocos", speed=0.5))[0]
    fast = model.run(inputs("vocos", speed=1.5))[0]
    assert len(slow) > len(fast)
