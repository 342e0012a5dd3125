"""The yardstick: kernel B1's bound and the model's FLOP count."""

import json

import numpy as np
import pytest

from benchmark.harness import yardstick as Y
from conftest import BENCH


def model_params(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text()
                      )["config"]["model_params"]


def test_b1_bound_at_frame_bucket_256():
    """One HiFi-GAN phase-2 evaluation at frame bucket 256, batch 1: 96
    launches whose bounds add up to 0.628 ms (chip_smoke.py's figure)."""
    dec = model_params("styletts2-lite-hifigan")["decoder"]
    launches = list(Y.b1_launches(dec, 256))
    assert len(launches) == 96
    total = sum(Y.b1_bound(1, t, c, k, 2, res) for c, t, k, res in launches)
    assert total == pytest.approx(0.628, abs=5e-4)
    assert Y.b1_bound_rows(dec, [256], 1) == pytest.approx(total, rel=1e-12)
    assert not list(Y.b1_launches(model_params("styletts2-lite-vocos")
                                  ["decoder"], 256))


def test_b1_bound_rows_is_under_the_sum_of_launches():
    dec = model_params("styletts2-lite-hifigan")["decoder"]
    rows = [300, 512, 97]
    per_launch = sum(Y.b1_bound(1, t, c, k, 2, res) for f in rows
                     for c, t, k, res in Y.b1_launches(dec, f))
    assert Y.b1_bound_rows(dec, rows, 3) <= per_launch + 1e-12
    assert Y.b1_bound_rows(dec, rows, 1) <= Y.b1_bound_rows(dec, rows, 3)


def hand_decoder_gflops_per_audio_s(hifigan: bool) -> float:
    """The decoder's FLOPs per second of audio (40 asr frames, 80 mel
    frames), counted term by term."""
    F, M = 40.0, 80.0
    g = 2 * F * (514 * 1024 * 3 + 1024 * 1024 * 3 + 514 * 1024)       # encode
    g += 3 * 2 * F * (1090 * 1024 * 3 + 1024 * 1024 * 3 + 1090 * 1024)
    g += 2 * M * (1090 * 512 * 3 + 512 * 512 * 3 + 1090 * 512 + 1090 * 3)
    g += 2 * F * 512 * 64                                             # asr_res
    if hifigan:
        c, rate = 512, M
        g += 2 * 24000 * 9                                           # source
        for u, k, knoise, nk in ((10, 20, 60, 7), (5, 10, 12, 7),
                                 (3, 6, 4, 7), (2, 4, 1, 11)):
            co, out = c // 2, rate * u
            g += 2 * rate * c * co * k
            g += 2 * out * co * knoise
            g += 3 * 2 * 2 * out * co * co * (3 + 7 + 11 + nk)
            c, rate = co, out
        g += 2 * 24000 * 32 * 7
    else:
        g += M * 8 * (2 * 512 * 7 + 2 * 2 * 512 * 1536)
        g += M * 2 * 512 * 1202 + M * 2.5 * 1200 * np.log2(1200)
    return g / 1e9


@pytest.mark.parametrize("name,hifigan", [("styletts2-lite-hifigan", True),
                                          ("styletts2-lite-vocos", False)])
def test_flops_per_audio_second(name, hifigan):
    mp = model_params(name)
    _, bf = Y.flops(mp, tokens=0, frames=40)
    assert bf / 1e9 == pytest.approx(hand_decoder_gflops_per_audio_s(hifigan),
                                     rel=1e-9)
    if hifigan:
        assert 65 < bf / 1e9 < 75   # the issue's ~69 GFLOP per audio second


def test_flops_phase1_per_token():
    mp = model_params("styletts2-lite-hifigan")
    f32, bf = Y.flops(mp, tokens=1, frames=0)
    assert bf == 0
    lstm = lambda i, h: 2 * 2 * 4 * h * (i + h)  # noqa: E731
    hand = (3 * 2 * 5 * 512 * 512 + lstm(512, 256) + 4 * lstm(640, 256)
            + 2 * 512 * 50)
    assert f32 == pytest.approx(hand, rel=1e-12)
    assert Y.least_seconds(mp, 1, 0) == pytest.approx(hand / Y.PEAK_F32)
