"""FLAC input: the port's flac.py against the JAX package's, for every
subframe type and stereo mode: the same encoder bytes, the same decode
bit for bit, the native decoder equal to the Python one, the same header
probe (audio.read_audio and audio.probe_duration_samples route FLAC by
its magic)."""

import numpy as np
import pytest
import torch

from styletts2_tpu import flac as JFL
from styletts2_tpu_torch import audio as AUD
from styletts2_tpu_torch import flac as TFL

torch.set_num_threads(1)

FLAC_CASES = ["constant", "verbatim", "fixed2", "lpc2", "independent",
              "left_side", "right_side", "mid_side"]


@pytest.mark.parametrize("case", FLAC_CASES)
def test_flac_matches_jax(case, tmp_path, monkeypatch):
    """Every subframe type and stereo mode: the port's encoder writes the
    JAX fixture encoder's bytes; its read_flac equals JAX's bit for bit;
    its native decoder equals its python one; the header probe agrees."""
    t = np.arange(6000) / 24000.0
    left = (0.4 * np.sin(2 * np.pi * 200 * t) + 0.02
            * np.random.default_rng(7).standard_normal(6000)).astype(
                np.float32)
    right = (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32)
    paths = []
    for mod in (TFL, JFL):
        p = str(tmp_path / f"{mod.__name__}.flac")
        if case == "constant":
            mod.write_flac(p, np.full(6000, 0.25, np.float32),
                           subframe="constant")
        elif case in ("verbatim", "fixed2", "lpc2"):
            mod.write_flac(p, left, subframe=case)
        else:
            mod.write_flac_stereo(p, left, right, mode=case)
        paths.append(p)
    data = open(paths[0], "rb").read()
    assert data == open(paths[1], "rb").read()
    want, sr = JFL.read_flac(paths[1])
    got, sr_got = AUD.read_audio(paths[0])
    assert sr_got == sr == 24000
    np.testing.assert_array_equal(got, want)
    assert TFL._read_flac_native(data) is not None  # g++ built it
    monkeypatch.setenv("STYLETTS2_TPU_TORCH_NO_NATIVE_FLAC", "1")
    np.testing.assert_array_equal(TFL.read_flac(paths[0])[0], want)
    assert TFL.probe_flac_info(paths[0]) == JFL.probe_flac_info(paths[1])
    assert AUD.probe_duration_samples(paths[0], 16000) == 4000
