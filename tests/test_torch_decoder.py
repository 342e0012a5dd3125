"""The port's decoder path against its JAX functions: interpolation, the NSF
sine source, the alignment, the HiFi-GAN generator (tools/golden.py SPECS)
and the decoder shell (the 512-wide generator of the tiny engine config),
all f32 on the CPU with padded buckets. The generator's AdaINResBlock1
conv pairs run kernel B1's plain version here.

Tolerances: interpolation and alignment are elementwise (1e-6); the
networks are true f32 on both sides with different summation orders
(atol 2e-4, rtol 1e-3, as tests/test_vocoder_pallas.py holds the fused
path to the XLA one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.config import DecoderConfig as JDecoderConfig
from styletts2_tpu.nn import decoder as JDE
from styletts2_tpu.ops import align as JALN
from styletts2_tpu.ops import stft as JS
from styletts2_tpu.tools.golden import SPECS
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import DecoderConfig
from styletts2_tpu_torch.nn import decoder as TDE
from styletts2_tpu_torch.ops import align as TALN
from styletts2_tpu_torch.ops import stft as TS

torch.set_num_threads(1)
NET_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("n_in,n_out", [(40, 400), (400, 40), (300, 100),
                                        (48, 30), (30, 48)])
def test_interpolate_linear_matches(n_in, n_out):
    """integer up, even and odd integer down, and general factors"""
    x = np.random.default_rng(n_in).standard_normal((2, 3, n_in)).astype(
        np.float32)
    want = JS.interpolate_linear(jnp.asarray(x), n_out)
    got = TS.interpolate_linear(torch.from_numpy(x), n_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(
        TS.interpolate_nearest(torch.from_numpy(x), 3).numpy(),
        np.asarray(JS.interpolate_nearest(jnp.asarray(x), 3)))


def test_sine_gen_and_alignment_match():
    rng = np.random.default_rng(1)
    f0 = np.abs(rng.standard_normal((2, 50 * 60, 1)) * 120 + 60).astype(
        np.float32)
    f0[:, :700] = 0.0  # an unvoiced stretch
    want, want_uv = JDE.sine_gen(jnp.asarray(f0), None, 60)
    got, got_uv = TDE.sine_gen(torch.from_numpy(f0), 60)
    np.testing.assert_array_equal(got_uv.numpy(), np.asarray(want_uv))
    # sin of a cumulative phase of up to ~2e3 rad: f32 ulps of the phase
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)

    durs = np.array([[3, 1, 4, 0, 2], [1, 1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        TALN.build_alignment(torch.from_numpy(durs), 12).numpy(),
        np.asarray(JALN.build_alignment(jnp.asarray(durs), 12)))


def _cfg_pair(**kw):
    return JDecoderConfig(type="hifigan", **kw), DecoderConfig(type="hifigan",
                                                                **kw)


def test_generator_matches():
    spec = dict(SPECS["hifigan_generator"])
    style_dim = spec.pop("style_dim")
    jcfg, tcfg = _cfg_pair(**spec)
    tree = jax.tree.map(np.asarray, JDE.hifigan_generator_init(
        jax.random.PRNGKey(3), jcfg, style_dim))
    from styletts2_tpu.convert import fuse_weight_norm
    rng = np.random.default_rng(3)
    b, t = 2, 24
    x = (rng.standard_normal((b, t, 64)) * 0.3).astype(np.float32)
    s = rng.standard_normal((b, style_dim)).astype(np.float32)
    f0 = (np.abs(rng.standard_normal((b, t))) * 100 + 80).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [17]])
    want = JDE.hifigan_generator_apply(
        fuse_weight_norm(tree), jnp.asarray(x), jnp.asarray(s),
        jnp.asarray(f0), None, jcfg, frame_mask=jnp.asarray(mask))

    gen = TDE.HiFiGANGenerator(tcfg, style_dim)
    W.load_param_tree({"g": gen}, {"g": tree})
    for m in gen.modules():
        if hasattr(m, "prepack"):
            m.prepack(torch.float32)
    with torch.no_grad():
        got = gen(torch.from_numpy(x), torch.from_numpy(s),
                  torch.from_numpy(f0), torch.from_numpy(mask))
    assert got.shape == want.shape
    # the NSF source's sin of an f32 phase of ~1e2 rad differs by f32
    # ulps between torch and XLA (~1e-5 relative, see the sine_gen test);
    # this random-weight generator amplifies that to ~7e-5 relative-l2
    # (1.2e-5 when both sides share the JAX source): bound 2e-4
    got, want = got.numpy(), np.asarray(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-4, rel
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_decoder_shell_matches():
    """decoder_apply with the tiny engine config's generator (the shell's
    512-channel output is the generator's upsample_initial_channel)."""
    jcfg, tcfg = _cfg_pair(upsample_initial_channel=512,
                           upsample_rates=[10, 6],
                           upsample_kernel_sizes=[20, 12],
                           resblock_kernel_sizes=[3],
                           resblock_dilation_sizes=[[1, 3]])
    dim_in, style_dim = 64, 32
    tree = jax.tree.map(np.asarray, JDE.decoder_init(
        jax.random.PRNGKey(4), jcfg, dim_in=dim_in, style_dim=style_dim))
    from styletts2_tpu.convert import fuse_weight_norm
    rng = np.random.default_rng(4)
    b, f = 2, 12
    asr = rng.standard_normal((b, f, dim_in)).astype(np.float32)
    f0 = (np.abs(rng.standard_normal((b, 2 * f))) * 100 + 80).astype(
        np.float32)
    n = rng.standard_normal((b, 2 * f)).astype(np.float32)
    s = rng.standard_normal((b, style_dim)).astype(np.float32)
    mask = np.arange(f)[None, :] < np.array([[f], [9]])
    want = JDE.decoder_apply(fuse_weight_norm(tree), jcfg, jnp.asarray(asr),
                             jnp.asarray(f0), jnp.asarray(n), jnp.asarray(s),
                             frame_mask=jnp.asarray(mask))

    dec = TDE.Decoder(tcfg, dim_in=dim_in, style_dim=style_dim)
    W.load_param_tree({"decoder": dec}, {"decoder": tree})
    with torch.no_grad():
        got = dec(torch.from_numpy(asr), torch.from_numpy(f0),
                  torch.from_numpy(n), torch.from_numpy(s),
                  torch.from_numpy(mask))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET_TOL)
