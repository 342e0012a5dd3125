"""The port's Vocos decoder against the JAX package, f32 on the CPU: the
ISTFT with 'same' padding, the committed reference golden, the generator
on the masked inference route and on the training route with its
gradients, the tiny engine's generate (the whole Decoder, masked), and
one D/G step with a checkpoint round trip. Vocos has no harmonic source
and reaches no kernel B1."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from styletts2_tpu.config import DecoderConfig as JDecoderConfig
from styletts2_tpu.convert import state_dict_to_tree
from styletts2_tpu.nn import vocos as JVOC
from styletts2_tpu.ops import stft as JS
from styletts2_tpu.tools.golden import SPECS, make_inputs
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import DecoderConfig
from styletts2_tpu_torch.nn.vocos import VocosGenerator
from styletts2_tpu_torch.ops import stft as S

import torch_istft_common as C

torch.set_num_threads(1)
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
# istft hop == the tiny engine's mel hop of 60
DECODER = {"type": "vocos", "intermediate_dim": 128, "num_layers": 2,
           "gen_istft_n_fft": 240, "gen_istft_hop_size": 60}


def test_istft_vocos_matches_jax():
    """Random spectra at the tiny engine's (240, 60) and the full width's
    (1200, 300) geometry: max abs error within 1e-5 of the max output (the
    envelope division at the trimmed edges included)."""
    rng = np.random.default_rng(0)
    for n_fft, hop, frames in ((240, 60, 41), (1200, 300, 23)):
        re, im = (rng.standard_normal((2, n_fft // 2 + 1, frames)).astype(
            np.float32) for _ in range(2))
        want = np.asarray(jax.jit(lambda a, b: JS.istft_vocos(
            a, b, n_fft, hop, n_fft))(re, im))
        got = S.istft_vocos(torch.from_numpy(re), torch.from_numpy(im),
                            n_fft, hop, n_fft).numpy()
        assert got.shape == want.shape == (2, frames * hop)
        assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_vocos_generator_golden():
    """Reference outputs (vocos.py:157-162 + ISTFTHead): atol 5e-3 of the
    reference's scale, as tests/test_golden_fixtures.py holds JAX."""
    data = np.load(os.path.join(FIXDIR, "golden_vocos_generator.npz"))
    sd = {k[3:]: data[k] for k in data.files
          if k.startswith("sd:") and k != "sd:stft.istft.window"}
    spec = dict(SPECS["vocos_generator"])
    style_dim, dim = spec.pop("style_dim"), spec.pop("dim")
    gen = VocosGenerator(DecoderConfig(type="vocos", **spec), style_dim, dim)
    W.load_param_tree({"g": gen}, {"g": state_dict_to_tree(sd)})
    inp = make_inputs("vocos_generator")
    with torch.no_grad():
        got = gen(torch.from_numpy(inp["x"].transpose(0, 2, 1)),
                  torch.from_numpy(inp["s"])).numpy().squeeze()
    ref = data["out:wav"].squeeze()
    assert got.shape == ref.shape
    scale = np.abs(ref).max() + 1e-6
    np.testing.assert_allclose(got / scale, ref / scale, atol=5e-3)


def test_generator_matches_jax():
    """The generator at tools/golden.py's sizes (dim 64, 2 ConvNeXt blocks,
    n_fft 40 / hop 10) against vocos_generator_apply: masked (row 1's
    padded frames still overlap-add, as on one JAX device) and
    training-route outputs rel-l2 < 5e-4, the training route's gradients
    of every parameter rel-l2 < 1e-3."""
    spec = dict(SPECS["vocos_generator"])
    style_dim, dim = spec.pop("style_dim"), spec.pop("dim")
    jcfg = JDecoderConfig(type="vocos", **spec)
    x = C.generator_inputs(6, dim)

    def make():
        return VocosGenerator(DecoderConfig(type="vocos", **spec), style_dim,
                              dim)

    tree = C.port_tree(make(), 6)

    def jax_apply(p, mask):
        return JVOC.vocos_generator_apply(p, jnp.asarray(x["x"]),
                                          jnp.asarray(x["s"]), jcfg,
                                          frame_mask=mask)

    out = C.generator_parity(make, tree, jax_apply, x)
    for route in ("masked", "train"):
        got, want = out[route]
        assert got.shape == want.shape == (2, 24 * 10, 1)
        assert C.rel_l2(got, want) < 5e-4, (route, C.rel_l2(got, want))
    assert C.rel_l2(*out["grads"]) < 1e-3, C.rel_l2(*out["grads"])


def test_engine_generate_matches_jax():
    """The tiny engine's generate (pinned durations, 102 of 120 frames)
    against the JAX engine, both two-phase: rel-l2 < 5e-4; the port's
    fused path equals its two-phase path."""
    want, got, fused = C.generate_pair(C.config(DECODER))
    assert got.shape == want.shape == (17 * C.FIXED_FRAMES * 2 * 60,)
    assert C.rel_l2(got, want) < 5e-4, C.rel_l2(got, want)
    np.testing.assert_array_equal(fused, got)


def test_train_step_and_checkpoint(tmp_path):
    """One D/G step: no source draws (Vocos has no sine source)."""
    metrics = C.train_step_and_checkpoint(C.config(DECODER), tmp_path)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
