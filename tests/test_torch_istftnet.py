"""The port's iSTFTNet decoder against the JAX package, f32 on the CPU: the
source STFT and the conv iSTFT, the committed reference golden, the whole
generator on the masked inference route (kernel B1's plain version, at
the odd-length last stage) and on the training route with its gradients,
the tiny engine's generate (the whole Decoder, masked), and one D/G step
with a checkpoint round trip.

The source STFT's phase is branch-cut ambiguous: a bin whose true phase
is near +-pi, or a quiet bin (magnitude near the 1e-5 floor), takes
either sign from rounding, and torch and XLA round the DFT products and
the sine source differently (on a harmonic source wave, ~2000 of ~32k
bins, all below 1e-4 of the peak magnitude). The
random-weight noise convs turn a 2*pi flip into a ~0.2 rel-l2 change of
the output. So the generator parity injects one shared (magnitude, phase),
as tests/test_golden_fixtures.py and test_models_parity.py do for the JAX
package, and the STFT itself is compared where the phase is defined:
|im| > 1e-3 * magnitude, with the phase error weighted by the magnitude.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

import styletts2_tpu.nn.istftnet as JINET
from styletts2_tpu.config import DecoderConfig as JDecoderConfig
from styletts2_tpu.convert import state_dict_to_tree
from styletts2_tpu.ops import stft as JS
from styletts2_tpu.tools.golden import SPECS, make_inputs
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import (DecoderConfig, load_config,
                                        with_decoder_type)
from styletts2_tpu_torch.nn.istftnet import ISTFTNetGenerator
from styletts2_tpu_torch.ops import stft as S

import torch_istft_common as C

torch.set_num_threads(1)
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
# prod(rates) * istft hop == the tiny engine's mel hop of 60
DECODER = {"type": "istftnet", "upsample_initial_channel": 512,
           "upsample_rates": [2, 6], "upsample_kernel_sizes": [4, 12],
           "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]],
           "gen_istft_n_fft": 20, "gen_istft_hop_size": 5}


def _source_wave(b=2, t=24 * 300, seed=3):
    """A harmonic source like the generator's: tanh of a bank of harmonics
    of a random F0 contour (offset, so low bins are loud and high ones
    quiet)."""
    rng = np.random.default_rng(seed)
    f0 = 80 + 100 * np.abs(np.cumsum(rng.standard_normal((b, t)), axis=1)
                           / np.sqrt(t))
    phase = 2 * np.pi * np.cumsum(f0, axis=1) / 24000
    w = rng.uniform(-0.3, 0.3, 9)
    bank = sum(w[h] * 0.1 * np.sin((h + 1) * phase) for h in range(9))
    return np.tanh(bank - 0.2).astype(np.float32)


def test_stft_mag_phase_and_istft_conv_match_jax():
    """Magnitude within 1e-5 of its max; the phase where |im| > 1e-3 * mag
    (away from the snap to 0 / pi) with |d phase| * mag within 1e-5 of the
    max magnitude, and exactly where both sides snap (|im| < 5e-4 * mag,
    not quiet); the bins that differ by more than 1e-3 rad are counted.
    Then the conv iSTFT of random (mag, phase) within 1e-5 of its max."""
    x = _source_wave()
    jm, jp = (np.asarray(a) for a in jax.jit(
        lambda w: JS.stft_mag_phase(w, 20, 5, 20, center=True,
                                    pad_mode="replicate"))(x))
    tm, tp = (a.numpy() for a in S.stft_mag_phase(torch.from_numpy(x), 20,
                                                  5, 20))
    assert tm.shape == jm.shape == (2, 11, 24 * 300 // 5 + 1)
    peak = jm.max()
    assert np.abs(tm - jm).max() < 1e-5 * peak
    frames = S.frame_signal(torch.from_numpy(x), 20, 5, True,
                            "replicate").double()
    _, sin_b = S.dft_bases(20, 20, False)
    im = torch.matmul(frames, sin_b.double()).transpose(1, 2).numpy()
    ratio = np.abs(im) / np.maximum(jm, 1e-30)
    dphase = np.abs(tp - jp)
    defined = ratio > 1e-3
    assert (dphase * jm)[defined].max() < 1e-5 * peak
    snapped = (ratio < 5e-4) & (jm > 1e-4 * peak)
    np.testing.assert_array_equal(tp[snapped], jp[snapped])
    differ = dphase > 1e-3
    at_snap = differ & (ratio >= 5e-4) & (ratio <= 2e-3)
    print(f"phase bins differing by > 1e-3 rad: {int(differ.sum())} of "
          f"{differ.size}; {int(at_snap.sum())} within 2x of the snap "
          f"ratio, the rest quiet (magnitude <= "
          f"{float(jm[differ & ~at_snap].max(initial=0) / peak):.2g} of the "
          f"peak)")

    rng = np.random.default_rng(1)
    mag = np.exp(rng.standard_normal((2, 11, 241)).astype(np.float32))
    ph = np.sin(rng.standard_normal((2, 11, 241)).astype(np.float32))
    want = np.asarray(jax.jit(lambda m, p: JS.istft_conv(m, p, 20, 5, 20))(
        mag, ph))
    got = S.istft_conv(torch.from_numpy(mag), torch.from_numpy(ph), 20, 5,
                       20).numpy()
    assert got.shape == want.shape == (2, 1, 1200)
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_istftnet_generator_golden(monkeypatch):
    """The reference's recorded harmonic source STFT injected, as
    tests/test_golden_fixtures.py does for JAX: corr > 0.9999 and atol
    5e-3 of the reference's scale (unmasked plain route)."""
    data = np.load(os.path.join(FIXDIR, "golden_istftnet_generator.npz"))
    sd = {k[3:]: data[k] for k in data.files
          if k.startswith("sd:") and not k.startswith("sd:stft.")}
    spec = dict(SPECS["istftnet_generator"])
    style_dim = spec.pop("style_dim")
    gen = ISTFTNetGenerator(DecoderConfig(type="istftnet", **spec), style_dim)
    W.load_param_tree({"g": gen}, {"g": state_dict_to_tree(sd)})
    feats = np.concatenate([data["out:har_spec"], data["out:har_phase"]],
                           axis=1).transpose(0, 2, 1)
    monkeypatch.setattr(ISTFTNetGenerator, "source_features",
                        lambda self, f0, source=None: torch.from_numpy(feats))
    inp = make_inputs("istftnet_generator")
    with torch.no_grad():
        got = gen(torch.from_numpy(inp["x"].transpose(0, 2, 1)),
                  torch.from_numpy(inp["s"]),
                  torch.from_numpy(inp["f0"])).numpy().squeeze()
    ref = data["out:wav"].squeeze()
    assert got.shape == ref.shape
    scale = np.abs(ref).max() + 1e-6
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.9999
    np.testing.assert_allclose(got / scale, ref / scale, atol=5e-3)


def test_generator_matches_jax(monkeypatch):
    """The tiny engine's generator at tools/golden.py's channels (C 32 /
    16; last stage T = 12 * 24 + 1 = 289 rows, odd, row 1 valid to 12 *
    19 + 1) against istftnet_generator_apply with one source STFT shared
    (see the module docstring): masked and training-route outputs rel-l2
    < 5e-4, the training route's gradients of every parameter rel-l2 <
    1e-3 (the source's linear gets none on either side: it is outside the
    graph)."""
    spec = dict(DECODER, upsample_initial_channel=64)
    spec.pop("type")
    style_dim = 32
    jcfg = JDecoderConfig(type="istftnet", **spec)
    x = C.generator_inputs(5, spec["upsample_initial_channel"])

    def make():
        return ISTFTNetGenerator(DecoderConfig(type="istftnet", **spec),
                                 style_dim)

    tree = C.port_tree(make(), 5)
    src = make()
    W.load_param_tree({"g": src}, {"g": tree})
    with torch.no_grad():
        feats = src.source_features(torch.from_numpy(x["f0"]))
    mag, phase = (jnp.asarray(a.transpose(1, 2).numpy())
                  for a in feats.split(11, dim=2))
    monkeypatch.setattr(JINET.OPS, "stft_mag_phase",
                        lambda *a, **k: (mag, phase))
    monkeypatch.setattr(ISTFTNetGenerator, "source_features",
                        lambda self, f0, source=None: feats)

    def jax_apply(p, mask):
        return JINET.istftnet_generator_apply(
            p, jnp.asarray(x["x"]), jnp.asarray(x["s"]), jnp.asarray(x["f0"]),
            None, jcfg, frame_mask=mask)

    out = C.generator_parity(make, tree, jax_apply, x)
    for route in ("masked", "train"):
        got, want = out[route]
        assert got.shape == want.shape == (2, 24 * 60, 1)
        assert C.rel_l2(got, want) < 5e-4, (route, C.rel_l2(got, want))
    assert C.rel_l2(*out["grads"]) < 1e-3, C.rel_l2(*out["grads"])


def test_engine_generate_matches_jax(monkeypatch):
    """The tiny engine's generate (pinned durations, 102 of 120 frames:
    the whole Decoder on its masked route) against the JAX engine, both
    two-phase: rel-l2 < 5e-4; the port's fused path equals its two-phase
    path. The random weights predict an unvoiced F0 here (checked), so the
    source is a constant and its STFT phase has no branch-cut bins."""
    f0_max = []
    features = ISTFTNetGenerator.source_features

    def recorded(self, f0, source=None):
        f0_max.append(float(f0.max()))
        return features(self, f0, source)

    monkeypatch.setattr(ISTFTNetGenerator, "source_features", recorded)
    want, got, fused = C.generate_pair(C.config(DECODER))
    assert f0_max and max(f0_max) < 10.0, f0_max  # sine_gen's voicing floor
    assert got.shape == want.shape == (17 * C.FIXED_FRAMES * 2 * 60,)
    assert C.rel_l2(got, want) < 5e-4, C.rel_l2(got, want)
    np.testing.assert_array_equal(fused, got)


def test_with_decoder_type_applies_the_type_defaults():
    """config_example.yaml with its type changed by
    config.with_decoder_type: the documented full-width architectures."""
    with open(os.path.join(os.path.dirname(os.path.dirname(FIXDIR)),
                           "configs", "config_example.yaml")) as f:
        raw = yaml.safe_load(f)
    ist = load_config(with_decoder_type(raw, "istftnet")).model_params.decoder
    assert (ist.upsample_rates, ist.upsample_kernel_sizes,
            ist.gen_istft_n_fft, ist.gen_istft_hop_size) == ([10, 6], [20, 12],
                                                             20, 5)
    assert ist.resblock_kernel_sizes == [3, 7, 11]
    voc = load_config(with_decoder_type(raw, "vocos")).model_params.decoder
    assert (voc.gen_istft_n_fft, voc.gen_istft_hop_size, voc.num_layers,
            voc.intermediate_dim) == (1200, 300, 8, 1536)
    assert raw["model_params"]["decoder"]["type"] == "hifigan"


def test_train_step_and_checkpoint(tmp_path):
    metrics = C.train_step_and_checkpoint(C.config(DECODER), tmp_path)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
