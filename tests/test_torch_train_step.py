"""The port's train step on the CPU, torch only, at a tiny config: the
composed glue losses against the reference golden values, one D/G step
(finite, every trainable module moved, the pitch extractor untouched, no
kernel-B1 call, optimizer state chaining into a second step), remat
against the baseline and grad_accum against the mean of its
micro-batches."""

import copy
import os

import numpy as np
import pytest
import torch

from styletts2_tpu.tools.golden import SPECS, make_inputs
from styletts2_tpu_torch import train as TT
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.models import build_model
from styletts2_tpu_torch.nn.asr import ASRCNN
from styletts2_tpu_torch.nn.predictor import ProsodyPredictor
from styletts2_tpu_torch.nn.style_encoder import StyleEncoder
from styletts2_tpu_torch.nn.text_encoder import TextEncoder
from styletts2_tpu_torch.ops import vocoder_kernel as VK

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
torch.set_num_threads(1)

TINY = {
    "max_len": 66,
    "preprocess_params": {"spect_params": {"n_fft": 512, "win_length": 240,
                                           "hop_length": 60}},
    "model_params": {
        "hidden_dim": 64, "max_conv_dim": 64, "dim_in": 16, "style_dim": 32,
        "max_dur": 10,
        "ASR_params": {"input_dim": 80, "hidden_dim": 64, "n_layers": 2,
                       "token_embedding_dim": 64},
        "decoder": {"type": "hifigan", "upsample_initial_channel": 512,
                    "upsample_rates": [10, 6],
                    "upsample_kernel_sizes": [20, 12],
                    "resblock_kernel_sizes": [3],
                    "resblock_dilation_sizes": [[1, 3]]}},
    "tpu": {"decoder_dtype": "float32"}, "debug": False}


def test_composed_train_glue_golden(monkeypatch):
    """dur / ce / s2s / mono / f0 / norm through the port's
    generator_losses on the committed small-module weights (reference
    train.py:202-315), as tests/test_golden_fixtures.py replays it for
    JAX: the aligner's attention replaced by the fixture's peaked one, the
    JDC target injected, decoder and waveform losses neutralised, the mono
    branch and crop offset 0."""
    spec = SPECS["composed_train"]
    data = np.load(os.path.join(FIXDIR, "golden_composed_train.npz"))
    te, se, pr, al = (spec[k] for k in ("text_encoder", "style_encoder",
                                        "predictor", "aligner"))
    mods = {
        "text_encoder": TextEncoder(te["channels"], te["kernel_size"],
                                    te["depth"], te["n_symbols"]),
        "style_encoder": StyleEncoder(se["dim_in"], se["style_dim"],
                                      se["max_conv_dim"]),
        "predictor": ProsodyPredictor(pr["style_dim"], pr["d_hid"],
                                      pr["nlayers"], pr["max_dur"]),
        "text_aligner": ASRCNN(al["input_dim"], al["hidden_dim"],
                               al["n_token"], al["n_layers"],
                               al["token_embedding_dim"]),
    }
    for name, mod in mods.items():
        W.split_weight_norm(mod)
        prefix = f"sd:{name}."
        sd = {k[len(prefix):]: torch.from_numpy(data[k])
              for k in data.files if k.startswith(prefix)}
        sd.pop("to_mfcc.dct_mat", None)  # the reference's DCT buffer
        mod.load_state_dict(sd, strict=True)
    inp = make_inputs("composed_train")
    b, crop = spec["b"], spec["crop"]
    t_mel = 2 * crop + 2
    aligner = mods["text_aligner"]
    synth = torch.from_numpy(inp["attn"])

    def aligner_with_attn(mels, pad_mask, texts, gen):
        ctc, s2s, attn = aligner(mels, pad_mask, texts, gen)
        return ctc, s2s, torch.cat([attn[:, :1], synth], dim=1)

    f0_real = torch.from_numpy(data["out:f0_real"])
    mods["text_aligner"] = aligner_with_attn
    mods["pitch_extractor"] = lambda gt: (f0_real, None)
    mods["decoder"] = lambda *a: torch.zeros(b, crop * 600, 1)
    mods["mpd"] = mods["msd"] = None
    zero = lambda *a, **k: torch.tensor(0.0)  # noqa: E731
    monkeypatch.setattr(TT.LO, "multi_resolution_stft_loss", zero)
    monkeypatch.setattr(TT.LO, "generator_loss", zero)

    cfg = load_config({"max_len": 2 * crop})
    batch = TT.Batch(torch.from_numpy(inp["waves"]),
                     torch.from_numpy(inp["texts"]),
                     torch.from_numpy(inp["lengths"]),
                     torch.full((b,), t_mel, dtype=torch.int64))
    mels = TT.compute_mels(batch.waves, cfg.model_params,
                           cfg.preprocess_params.spect_params)
    assert mels.shape[-1] == t_mel
    draws = TT.Draws(coin=False, starts=torch.zeros(b, dtype=torch.int64),
                     source=(torch.zeros(1), torch.zeros(1)))
    with torch.no_grad():
        _, (_, _, metrics) = TT.generator_losses(
            mods, batch, mels, None, cfg.model_params, cfg.loss_params, crop,
            train=False, draws=draws)
    ref = {k[len("out:loss_"):]: float(data[k]) for k in data.files
           if k.startswith("out:loss_")}
    for k, want in ref.items():
        assert float(metrics[k]) == pytest.approx(want, rel=2e-2, abs=2e-3), \
            (k, float(metrics[k]), want)


@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(TINY)
    mods = build_model(cfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(0))
    W.split_weight_norm(mods)
    mods.train()
    mods["pitch_extractor"].eval().requires_grad_(False)
    rng = np.random.default_rng(0)
    b, t_text, t_mel = 2, 12, 80
    batch = TT.Batch(
        torch.from_numpy((rng.standard_normal((b, t_mel * 60)) * 0.1)
                         .astype(np.float32)),
        torch.from_numpy(rng.integers(4, 170, (b, t_text))),
        torch.tensor([t_text, t_text - 3]), torch.tensor([t_mel, t_mel - 10]))
    return cfg, mods, batch


def _params(mods, k):
    return [p.detach().clone() for p in mods[k].parameters()]


@pytest.fixture(scope="module")
def stepped(tiny):
    """Two make_train_step steps on a copy of the tiny modules from
    generator seed 21, kernel B1's wrapper made to raise: the metrics and
    optimizer states after each, and which parameters the first moved."""
    from styletts2_tpu_torch.optim import MultiOptimizer

    cfg, mods, batch = tiny
    mods = copy.deepcopy(mods)  # the fixture's weights stay as they are

    def no_b1(*a, **k):
        raise AssertionError("kernel B1 reached from the training step")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(VK, "ada_snake_conv", no_b1)
        opt = MultiOptimizer(mods)
        step = TT.make_train_step(cfg, opt)
        gen = torch.Generator().manual_seed(21)
        before = {k: _params(mods, k) for k in mods}
        m1 = step(mods, batch, gen)
        moved = {k: [not torch.equal(a, p) for a, p in
                     zip(before[k], mods[k].parameters())] for k in mods}
        st1 = opt.state_trees()
        m2 = step(mods, batch, gen)
        st2 = opt.state_trees()
    return m1, moved, st1, m2, st2


@pytest.fixture(scope="module")
def g_baseline(tiny):
    """g_grads (no remat) on the tiny modules as built, generator seed 21:
    the remat test's reference and the G step's stale-discriminator
    counterpart."""
    cfg, mods, batch = tiny
    _, g = TT.make_grad_fns(cfg)
    return g(mods, batch, torch.Generator().manual_seed(21))


def test_train_step_updates_modules_and_chains(stepped):
    m, moved, st1, m2, st2 = stepped
    assert set(m) == {"mel", "gen", "ce", "dur", "norm", "f0", "s2s", "mono",
                      "g_loss", "d_loss"}
    assert all(np.isfinite(float(v)) for v in m.values()), m
    for k in TT.GEN_MODULES + TT.DISC_MODULES:
        assert any(moved[k]), f"{k} did not move"
    assert not any(moved["pitch_extractor"])
    assert all(np.isfinite(float(v)) for v in m2.values()), m2
    for k in TT.GEN_MODULES + TT.DISC_MODULES:
        assert st1[k]["count"] == 1 and st2[k]["count"] == 2
    mu1 = st1["decoder"]["mu"]["generator"]["conv_post"]["weight_v"]
    mu2 = st2["decoder"]["mu"]["generator"]["conv_post"]["weight_v"]
    assert not np.array_equal(mu1, mu2)


def test_remat_matches_baseline(tiny, g_baseline):
    """torch.utils.checkpoint over the synthesis and the G-side
    discriminators recomputes the same forward: identical gradients."""
    cfg, mods, batch = tiny
    cfg = copy.deepcopy(cfg)
    cfg.tpu.remat = True
    _, g = TT.make_grad_fns(cfg)
    m1, g1 = g(mods, batch, torch.Generator().manual_seed(21))
    m0, g0 = g_baseline
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in g0:
        for a, b in zip(g0[k], g1[k]):
            assert torch.equal(a, b), k


def test_grad_accum_matches_micro_batch_mean(tiny):
    """grad_accum 2 == the mean of the two micro-batches' gradients, for
    the D and the G gradients (draws fixed, dropout off)."""
    cfg, mods, batch = tiny
    b = batch.waves.shape[0]
    draws = TT.Draws(coin=True, starts=torch.zeros(b, dtype=torch.int64),
                     source=(torch.rand(b, 9), torch.randn(b, 66 * 60, 9)),
                     dropout=False)
    fns = TT.make_grad_fns(cfg)
    for fn in fns:
        aux, grads = TT._accumulate(fn, mods, batch, None, 2, draws)
        parts = [fn(mods, mb, None, dr)
                 for mb, dr in zip(batch.split(2), draws.split(2))]
        for k in grads:
            for i, g in enumerate(grads[k]):
                want = (parts[0][1][k][i] + parts[1][1][k][i]) / 2
                torch.testing.assert_close(g, want, rtol=0, atol=0)
        if isinstance(aux, dict):
            for k in aux:
                torch.testing.assert_close(
                    aux[k], (parts[0][0][k] + parts[1][0][k]) / 2)


def test_decoder_training_smoothing(tiny):
    """smooth_f0n (its widths are held against JAX in
    test_torch_train_modules) composed with the training decoder: width 1
    leaves the decoder's output bit-identical, and the gradient reaching
    the raw curves is the box filter (its own adjoint) applied to the
    decoder's gradient at the smoothed curves."""
    from styletts2_tpu_torch.nn import decoder as DE

    cfg, mods, _ = tiny
    dec = mods["decoder"]
    rng = np.random.default_rng(13)
    f = 8
    asr = torch.from_numpy(rng.standard_normal((1, f, 64)).astype(np.float32))
    f0 = torch.from_numpy(
        (np.abs(rng.standard_normal((1, 2 * f))) * 100).astype(np.float32))
    n = torch.from_numpy(rng.standard_normal((1, 2 * f)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32))
    source = DE.draw_source(torch.Generator().manual_seed(0), 1, 2 * f * 60)
    with torch.no_grad():
        torch.testing.assert_close(
            dec(asr, *DE.smooth_f0n(f0, n, 1, 1), s, None, source),
            dec(asr, f0, n, s, None, source), rtol=0, atol=0)
    f0_raw = f0.clone().requires_grad_()
    n_raw = n.clone().requires_grad_()
    f0_s, n_s = DE.smooth_f0n(f0_raw, n_raw, 3, 7)
    f0_s.retain_grad()
    n_s.retain_grad()
    dec(asr, f0_s, n_s, s, None, source).square().sum().backward()
    for raw, smooth, w in ((f0_raw, f0_s, 3), (n_raw, n_s, 7)):
        assert smooth.grad.abs().sum() > 0
        want = DE.smooth_f0n(smooth.grad, smooth.grad, w, w)[0]
        torch.testing.assert_close(raw.grad, want, rtol=1e-5, atol=1e-6)


def test_g_step_sees_updated_discriminators_and_d_draws(tiny, stepped,
                                                       g_baseline):
    """The G step runs against the D-updated mpd/msd, from the generator
    state the D step started from (reference train.py:272-328): its loss
    equals g_grads on the D-updated modules with the generator rewound,
    and differs from g_grads on the modules before the D update."""
    from styletts2_tpu_torch.optim import MultiOptimizer

    cfg, mods, batch = tiny
    got = stepped[0]
    stale = g_baseline[0]
    b = copy.deepcopy(mods)
    d_step, _ = TT.make_step_pair(cfg, MultiOptimizer(b))
    _, g_fn = TT.make_grad_fns(cfg)
    d_step(b, batch, torch.Generator().manual_seed(21))
    want, _ = g_fn(b, batch, torch.Generator().manual_seed(21))
    assert torch.equal(got["g_loss"], want["g_loss"])
    assert not torch.equal(got["gen"], stale["gen"])
