"""Kernel B2's plain version (styletts2_tpu_torch/ops/mel_kernel.py) against
the JAX package's mel front end: the XLA path of ops.stft.preprocess_wave
and the Pallas kernel fused_log_mel in interpret mode.

Tolerance atol 2e-5, rtol 1e-4 on the normalised log-mels, as
tests/test_mel_pallas.py holds the Pallas kernel to the XLA path: all
sides are true f32, so they differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styletts2_tpu.ops import stft as JS
from styletts2_tpu.ops.mel_pallas import fused_log_mel
from styletts2_tpu_torch.ops import mel_kernel as MK
from styletts2_tpu_torch.ops import stft as TS

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=1e-4)

# the style window (3 s at 24 kHz, 80 mels) and the three MRSTFT
# resolutions of losses.py (128 mels)
CASES = {
    "style": dict(t=72000, n_fft=2048, hop_length=300, win_length=1200,
                  n_mels=80),
    "mrstft_1024": dict(t=9600, n_fft=1024, hop_length=120, win_length=600,
                        n_mels=128),
    "mrstft_2048": dict(t=9600, n_fft=2048, hop_length=240, win_length=1200,
                        n_mels=128),
    "mrstft_512": dict(t=9600, n_fft=512, hop_length=50, win_length=240,
                       n_mels=128),
}


@pytest.mark.parametrize("name", list(CASES))
def test_log_mel_plain_matches_jax(name):
    case = dict(CASES[name])
    t = case.pop("t")
    rng = np.random.default_rng(len(name))
    wave = (rng.standard_normal((1, t)) * 0.3).astype(np.float32)
    xla = np.asarray(JS.preprocess_wave(jnp.asarray(wave), backend="xla",
                                        sr=24000, **case))
    pallas = np.asarray(fused_log_mel(jnp.asarray(wave), sr=24000,
                                      interpret=True, **case))
    got = MK.log_mel(torch.from_numpy(wave), sr=24000, **case).numpy()
    assert got.shape == xla.shape
    np.testing.assert_allclose(got, xla, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_frequency_split_matches_plain(name):
    """Kernel B2's decomposition on its own padded operands: one partial
    mel per TF-column frequency tile (what each block of the first pass
    writes), summed over the tiles in order (the second pass), then
    log-normalised, equals the plain version."""
    case = dict(CASES[name])
    t = case.pop("t")
    rng = np.random.default_rng(len(name) + 11)
    wave = torch.from_numpy((rng.standard_normal((1, t)) * 0.3)
                            .astype(np.float32))
    cos_p, sin_p, fb_p = MK._device_bases(
        24000, case["n_fft"], case["win_length"], case["n_mels"],
        torch.device("cpu"))
    assert cos_p.shape[1] % MK.TF == 0 and fb_p.shape[1] % 16 == 0
    frames = TS.frame_signal(wave, case["n_fft"], case["hop_length"])[0]
    mel = torch.zeros(frames.shape[0], fb_p.shape[1])
    for f0 in range(0, cos_p.shape[1], MK.TF):
        re = frames @ cos_p[:, f0:f0 + MK.TF]
        im = frames @ sin_p[:, f0:f0 + MK.TF]
        mel = mel + (re * re + im * im) @ fb_p[f0:f0 + MK.TF]
    got = TS.log_mel_normalize(mel[:, :case["n_mels"]].T[None])
    want = MK.log_mel_plain(wave, sr=24000, **case)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_preprocess_wave_routes_to_b2_plain_on_cpu():
    """The engine's entry (ops.stft.preprocess_wave) on a CPU batch equals
    the plain version row by row and never launches the kernel."""
    rng = np.random.default_rng(7)
    wave = torch.from_numpy((rng.standard_normal((3, 24000)) * 0.2)
                            .astype(np.float32))
    out = TS.preprocess_wave(wave)
    assert out.shape == (3, 80, 81)
    for i in range(3):
        np.testing.assert_allclose(out[i:i + 1].numpy(),
                                   MK.log_mel_plain(wave[i:i + 1]).numpy(),
                                   atol=1e-6, rtol=1e-6)
    assert MK.log_mel.launches == 0


def test_bases_match_jax():
    """DFT bases (integer range reduction, zeroed DC/Nyquist imaginary
    columns) and the htk filterbank match the JAX package's."""
    cos_t, sin_t = TS.dft_bases(2048, 1200)
    cos_j, sin_j = JS._traced_dft_bases(2048, 1200, True)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=2e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=2e-6)
    assert not sin_t[:, 0].any() and not sin_t[:, -1].any()
    for n_fft, n_mels in ((2048, 80), (512, 128)):
        np.testing.assert_allclose(
            TS.mel_filterbank(24000, n_fft, n_mels),
            np.asarray(JS._traced_mel_fb(24000, n_fft, n_mels)), atol=1e-5)
