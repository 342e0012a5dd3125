"""The port's engine (styletts2_tpu_torch.infer.StyleTTS2, device="cpu")
against the JAX engine's two-phase path on the tiny config of
tests/test_quick_e2e.py (hop 60, rates [10, 6], f32 decoder), both built
from the same JAX build_model parameters.

Single-chunk texts only: the JAX batched multi-chunk path disagrees with
itself (test_infer.py::test_chunk_batching_matches_single). Both engines
take the two-phase path here; test_torch_serving.py holds the fused path
and the batched plan."""

import jax
import numpy as np
import pytest
import torch

from styletts2_tpu.config import load_config as jax_load_config
from styletts2_tpu.infer import StyleTTS2 as JaxStyleTTS2
from styletts2_tpu.models import build_model
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.infer import StyleTTS2

torch.set_num_threads(1)

CFG = {
    "preprocess_params": {"spect_params": {"n_fft": 512, "win_length": 240,
                                           "hop_length": 60}},
    "model_params": {
        "hidden_dim": 64, "max_conv_dim": 64, "dim_in": 16,
        "style_dim": 32, "max_dur": 10,
        "decoder": {"type": "hifigan", "upsample_initial_channel": 512,
                    "upsample_rates": [10, 6],
                    "upsample_kernel_sizes": [20, 12],
                    "resblock_kernel_sizes": [3],
                    "resblock_dilation_sizes": [[1, 3]]},
    },
    "tpu": {"token_buckets": [24, 48], "frame_buckets": [60, 120, 240],
            "decoder_dtype": "float32"},
    "debug": False,
}
TEXT = "hello there you"  # one chunk, 17 tokens


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_load_config(CFG)
    params = jax.tree.map(np.asarray,
                          build_model(jax.random.PRNGKey(0), jcfg.model_params))
    jax_engine = JaxStyleTTS2(jcfg, params=params, seed=0)
    jax_engine.fused_enabled = False  # the two-phase path on both sides
    port = StyleTTS2(load_config(CFG), params=params, seed=0, device="cpu")
    port.fused_enabled = False
    return jax_engine, port


@pytest.fixture(scope="module")
def style(engines):
    jax_engine, port = engines
    wav = (np.random.default_rng(0).standard_normal(24000 * 5) * 0.1).astype(
        np.float32)
    want = np.asarray(jax_engine.compute_style(wav, denoise=0.3))
    got = port.compute_style(wav, denoise=0.3).cpu().numpy()
    return want, got


def test_compute_style_matches(style):
    """3-s windows + a 2-s tail through B2's plain version and the style
    encoder; f32 on both sides (atol 1e-4, rtol 1e-4)."""
    want, got = style
    assert got.shape == want.shape == (1, 32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_compute_style_from_wav_file(engines, tmp_path):
    """A 16-bit 16 kHz WAV path: read, resample to 24 kHz, trim, one
    whole-second window (a < 4-s clip), no denoise."""
    import wave

    jax_engine, port = engines
    t = np.arange(16000 * 2) / 16000
    pcm = (0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype("<i2")
    path = str(tmp_path / "ref.wav")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    want = np.asarray(jax_engine.compute_style(path, denoise=0.0))
    got = port.compute_style(path, denoise=0.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_phase1_durations_match(engines, style):
    """Phase-1 durations as floats (rtol 1e-5: f32 LSTM stacks), then the
    host glue with the stabilisation noise of the same chain stream gives
    equal integer durations."""
    jax_engine, port = engines
    s = style[0]
    tk = port.cleaner  # same symbol table on both sides
    from styletts2_tpu_torch.text import tokens_for_sentence
    toks = tokens_for_sentence(TEXT, tk)
    tb = 24
    tokens = np.zeros((1, tb), np.int32)
    tokens[0, : len(toks)] = toks
    mask = np.arange(tb)[None, :] < len(toks)
    _, _, want = jax_engine._phase1(jax_engine.params, tokens, mask, s)
    _, _, got = port._phase1(torch.from_numpy(tokens).long(),
                             torch.from_numpy(mask), torch.tensor(s))
    want = np.asarray(want)[0, : len(toks)]
    got = got.numpy()[0, : len(toks)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for t, prev, speed, scale in ((0.0, 0.0, 1.0, None),
                                  (0.2, 0.0, 1.0, None),
                                  (0.2, 4.5, 1.3, None),
                                  (0.2, 0.0, 1.0, 2.5)):
        jax_engine.duration_scale = port.duration_scale = scale
        try:
            want_d, _, want_mean = jax_engine._postprocess_durations(
                want.copy(), speed, prev, t,
                rng=np.random.default_rng([7, 0]))
            got_d, got_mean = port._postprocess_durations(
                got.copy(), speed, prev, t, np.random.default_rng([7, 0]))
        finally:
            jax_engine.duration_scale = port.duration_scale = None
        np.testing.assert_array_equal(got_d, want_d)
        assert got_mean == pytest.approx(want_mean, rel=1e-5)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_waveform_matches_with_pinned_durations(engines, style):
    """generate() with pinned durations, f32: int16 PCM steps plus the NSF
    source's f32 phase ulps amplified by random weights (see
    test_torch_decoder.py) — measured 8e-5 relative-l2, bound 5e-4."""
    jax_engine, port = engines
    st = {"style": style[0], "speed": 1.0}
    jax_engine.fixed_duration = port.fixed_duration = 10
    try:
        want = jax_engine.generate(TEXT, st, stabilize=True, n_merge=8)
        got = port.generate(TEXT, st, stabilize=True, n_merge=8)
    finally:
        jax_engine.fixed_duration = port.fixed_duration = None
    assert got.shape == want.shape == (17 * 10 * 2 * 60,)
    assert np.abs(got[:4000]).max() == 0 and np.abs(got[-4000:]).max() == 0
    assert _rel_l2(got, want) < 5e-4


def test_waveform_matches_with_predicted_durations(engines, style):
    """The full duration path (stabilize=True: one base-seed draw per
    generate from the engine RNG, chain noise default_rng([seed, 0])):
    same lengths, same waveform within the pinned test's bound."""
    jax_engine, port = engines
    st = {"style": style[0], "speed": 1.0}
    jax_engine._rng = np.random.default_rng(11)
    port._rng = np.random.default_rng(11)
    want = jax_engine.generate(TEXT, st, stabilize=True, n_merge=8)
    got = port.generate(TEXT, st, stabilize=True, n_merge=8)
    assert got.shape == want.shape
    assert _rel_l2(got, want) < 5e-4


def test_native_checkpoint_and_style_files(engines, style, tmp_path):
    """models_path takes a native .ckpt (the JAX package's pickle of numpy
    trees); save_styles/load_styles round-trip the style exactly."""
    from styletts2_tpu.checkpoint import save_checkpoint

    _, port = engines
    params = jax.tree.map(np.asarray, build_model(
        jax.random.PRNGKey(1), jax_load_config(CFG).model_params))
    ckpt = tmp_path / "model.ckpt"
    save_checkpoint(str(ckpt), params)
    loaded = StyleTTS2(load_config(CFG), str(ckpt), device="cpu")
    want = params["text_encoder"]["embedding"]["weight"]
    got = loaded.modules["text_encoder"].embedding.weight.detach().numpy()
    np.testing.assert_array_equal(got, want)

    port.ref_s = torch.tensor(style[1])
    port.save_styles(str(tmp_path / "style.npy"))
    port.ref_s = None
    port.load_styles(str(tmp_path / "style.npy"))
    got = port.get_styles({"path": None}, load_styles=True)
    np.testing.assert_array_equal(got["style"].numpy(), style[1])
