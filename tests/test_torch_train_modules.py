"""The training slice's modules against the committed reference golden
fixtures and against the JAX functions, f32 on the CPU: the aligner, the
pitch extractor, the period discriminator, the loss library, the
monotonic alignment, the mel-derived features, B2's gradient, the
optimizer, and kernel B1's inference-only guard."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styletts2_tpu import losses as JLO
from styletts2_tpu.ops import align as JALN
from styletts2_tpu.ops import stft as JS
from styletts2_tpu.tools.golden import SPECS, make_inputs, synth_state_dict
from styletts2_tpu_torch import losses as LO
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.nn import asr as ASR
from styletts2_tpu_torch.nn import discriminators as DISC
from styletts2_tpu_torch.nn import jdc as JDC
from styletts2_tpu_torch.ops import align as ALN
from styletts2_tpu_torch.ops import mel_kernel as MK
from styletts2_tpu_torch.ops import stft as S

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
torch.set_num_threads(2)


def _fixture(name):
    data = np.load(os.path.join(FIXDIR, f"golden_{name}.npz"))
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd:")}
    return sd, data


def _synth(module, seed):
    """The golden synthetic weights (golden.synth_state_dict) for a port
    module: keys and shapes must mirror the reference state dict."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            synth_state_dict(shapes, seed).items()},
                           strict=True)
    return module


def test_asr_golden():
    """Aligner vs the reference outputs (ASR/models.py:8-186): CTC head,
    teacher-forced s2s logits, soft attention; unk masking off."""
    sd, data = _fixture("asr")
    s = SPECS["asr"]
    m = ASR.ASRCNN(s["input_dim"], s["hidden_dim"], s["n_token"],
                   s["n_layers"], s["token_embedding_dim"])
    np.testing.assert_allclose(S.dct_matrix(40, 80).numpy(),
                               sd.pop("to_mfcc.dct_mat").numpy(),
                               atol=1e-6)
    m.load_state_dict(sd, strict=True)
    inp = make_inputs("asr")
    lengths = inp["lengths"]
    l_mem = int(lengths.max())
    pad_mask = torch.from_numpy(np.arange(l_mem)[None, :] + 1
                                > lengths[:, None])
    with torch.no_grad():
        ctc, s2s, attn = m(torch.from_numpy(inp["mel"]), pad_mask,
                           torch.from_numpy(inp["text"]))
    np.testing.assert_allclose(ctc.numpy(), data["out:ctc"], atol=2e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(s2s.numpy(), data["out:s2s"], atol=5e-3,
                               rtol=1e-2)
    np.testing.assert_allclose(attn.numpy(), data["out:attn"], atol=2e-4)


def test_jdc_golden():
    """Full-size pitch extractor on the synthetic weights vs the reference
    F0 (JDC/model.py:102-137)."""
    m = _synth(JDC.JDCNet(), SPECS["jdc"]["seed"]).eval()
    data = np.load(os.path.join(FIXDIR, "golden_jdc.npz"))
    with torch.no_grad():
        f0, _ = m(torch.from_numpy(make_inputs("jdc")["mel"]))
    np.testing.assert_allclose(f0.numpy(), data["out:f0"], atol=2e-3,
                               rtol=1e-2)


def test_mpd_golden():
    """One full-size DiscriminatorP weight set at periods 2 and 3: logits
    and every feature map (reflect pad on a length no period divides)."""
    spec = SPECS["mpd_p"]
    d = DISC.DiscriminatorP(2)
    W.split_weight_norm(d)
    _synth(d, spec["seed"])
    data = np.load(os.path.join(FIXDIR, "golden_mpd.npz"))
    y = torch.from_numpy(make_inputs("mpd_p")["y"])
    for period in spec["periods"]:
        d.period = period
        with torch.no_grad():
            logits, fmap = d(y)
        np.testing.assert_allclose(logits.numpy(),
                                   data[f"out:p{period}_logits"],
                                   atol=2e-3, rtol=1e-2)
        for j, f in enumerate(fmap):
            np.testing.assert_allclose(f.numpy(),
                                       data[f"out:p{period}_fmap{j}"],
                                       atol=2e-3, rtol=1e-2)


def test_losses_golden():
    """MSD halves of the adversarial / feature / TPRLS losses on the
    committed full-size MSD, and the mel-domain MRSTFT (losses.py:24-147)."""
    sd, data = _fixture("losses")
    msd = DISC.MultiResSpecDiscriminator()
    W.split_weight_norm(msd)
    msd.load_state_dict(sd, strict=True)
    inp = make_inputs("losses")
    y, y_hat = torch.from_numpy(inp["y"]), torch.from_numpy(inp["y_hat"])
    with torch.no_grad():
        rs, gs, frs, fgs = msd(y, y_hat)
        ours = {
            "msd_gen_adv": LO.generator_adv_loss(gs),
            "msd_feature": LO.feature_loss(frs, fgs),
            "msd_gen_tprls": LO.generator_tprls_loss(rs, gs),
            "msd_disc_adv": LO.discriminator_adv_loss(rs, gs),
            "msd_disc_tprls": LO.discriminator_tprls_loss(rs, gs),
            "mrstft": LO.multi_resolution_stft_loss(y_hat, y),
        }
    for k, v in ours.items():
        want = float(data[f"out:{k}"])
        assert float(v) == pytest.approx(want, rel=5e-3, abs=2e-3), \
            (k, float(v), want)


def test_maximum_path_and_mask_match_jax():
    rng = np.random.default_rng(4)
    b, x, y = 3, 9, 30
    value = rng.standard_normal((b, x, y)).astype(np.float32)
    t_x = np.array([9, 6, 4])
    t_y = np.array([30, 21, 13])
    mask = np.asarray(JALN.mask_from_lens(jnp.asarray(t_x), jnp.asarray(t_y),
                                          x, y))
    got_mask = ALN.mask_from_lens(torch.tensor(t_x), torch.tensor(t_y), x, y)
    np.testing.assert_array_equal(got_mask.numpy(), mask)
    value = np.where(mask, value, 0.0).astype(np.float32)
    want = np.asarray(JALN.maximum_path(jnp.asarray(value), jnp.asarray(t_x),
                                        jnp.asarray(t_y)))
    got = ALN.maximum_path(torch.from_numpy(value), torch.tensor(t_x),
                           torch.tensor(t_y))
    np.testing.assert_array_equal(got.numpy(), want)
    # a path: one text position per valid frame, monotonic
    assert np.array_equal(got.numpy().sum(axis=1)[0], np.ones(y))


def test_log_norm_and_mfcc_match_jax():
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((2, 80, 37)).astype(np.float32)
    np.testing.assert_allclose(S.log_norm(torch.from_numpy(mel)).numpy(),
                               np.asarray(JS.log_norm(jnp.asarray(mel))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(S.mfcc(torch.from_numpy(mel)).numpy(),
                               np.asarray(JS.mfcc(jnp.asarray(mel))),
                               rtol=1e-5, atol=1e-5)


def test_mrstft_value_and_gradient_match_jax():
    """The MRSTFT loss and its gradient in the prediction (JAX's XLA route
    on the CPU): value rel 1e-5, gradient rel-l2 1e-4."""
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 6000)) * 0.2).astype(np.float32)
    y = (rng.standard_normal((2, 6000)) * 0.2).astype(np.float32)
    want, want_g = jax.value_and_grad(JLO.multi_resolution_stft_loss)(
        jnp.asarray(x), jnp.asarray(y))
    xt = torch.from_numpy(x).requires_grad_()
    got = LO.multi_resolution_stft_loss(xt, torch.from_numpy(y))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    want_g = np.asarray(want_g)
    rel = (np.linalg.norm(xt.grad.numpy() - want_g)
           / np.linalg.norm(want_g))
    assert rel < 1e-4, rel


def test_constants_first_built_in_inference_mode_train():
    """The cached DSP constants first built under the engine's
    inference_mode stay normal tensors: a training step's backward in the
    same process must be able to save them (it raised "Inference tensors
    cannot be saved for backward" before)."""
    cached = (S.dft_bases, S.dct_matrix, MK._device_bases)
    for fn in cached:
        fn.cache_clear()
    rng = np.random.default_rng(14)
    x = torch.from_numpy((rng.standard_normal((1, 4000)) * 0.2)
                         .astype(np.float32))
    with torch.inference_mode():
        for fft, hop, win in LO.MRSTFT_RESOLUTIONS:
            MK.log_mel_plain(x, n_fft=fft, hop_length=hop, win_length=win,
                             n_mels=128)
        S.mfcc(torch.zeros(1, 80, 3))
        MK._device_bases(24000, 2048, 1200, 80, torch.device("cpu"))
    for t in (*S.dft_bases(2048, 1200), S.dct_matrix(40, 80),
              *MK._device_bases(24000, 2048, 1200, 80, torch.device("cpu"))):
        assert not t.is_inference()
    xt = x.clone().requires_grad_()
    LO.multi_resolution_stft_loss(xt, x.flip(-1)).backward()
    assert torch.isfinite(xt.grad).all() and xt.grad.abs().sum() > 0


def test_log_mel_gradient_matches_pallas_vjp():
    """B2's gradient: the port's against jax.vjp of the Pallas kernel
    (interpret mode, its custom VJP) on a short wave and a random
    cotangent, at an MRSTFT resolution; and the autograd.Function the
    CUDA path takes (its launch replaced by the plain formula here, so
    its backward wiring runs on the CPU) gives the same gradient."""
    from styletts2_tpu.ops.mel_pallas import fused_log_mel

    rng = np.random.default_rng(7)
    wave = (rng.standard_normal((2, 4800)) * 0.3).astype(np.float32)
    kw = dict(sr=24000, n_fft=1024, win_length=600, hop_length=120,
              n_mels=128)
    out, vjp = jax.vjp(lambda w: fused_log_mel(w, interpret=True, **kw),
                       jnp.asarray(wave))
    cot = rng.standard_normal(out.shape).astype(np.float32)
    want = np.asarray(vjp(jnp.asarray(cot))[0])

    w = torch.from_numpy(wave).requires_grad_()
    MK.log_mel(w, **kw).backward(torch.from_numpy(cot))
    rel = np.linalg.norm(w.grad.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel

    args = (kw["sr"], kw["n_fft"], kw["win_length"], kw["hop_length"],
            kw["n_mels"], S.LOG_MEL_MEAN, S.LOG_MEL_STD)
    orig = MK._launch
    MK._launch = lambda wv, *a: MK.log_mel_plain(wv.detach(), *a)
    try:
        w2 = torch.from_numpy(wave).requires_grad_()
        MK._LogMel.apply(w2, args).backward(torch.from_numpy(cot))
        with torch.inference_mode():  # the engine's style path
            MK._LogMel.apply(torch.from_numpy(wave), args)
    finally:
        MK._launch = orig
    np.testing.assert_array_equal(w2.grad.numpy(), w.grad.numpy())


def test_optimizer_matches_jax_multioptimizer():
    """Three AdamW steps per module (lr and ft_lr) against
    styletts2_tpu.optim.MultiOptimizer on the same gradients: rel 1e-5."""
    from styletts2_tpu.optim import MultiOptimizer as JaxOpt
    from styletts2_tpu_torch.optim import MultiOptimizer

    rng = np.random.default_rng(8)
    tree = {"decoder": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
            "mpd": {"w": rng.standard_normal((5,)).astype(np.float32)}}
    mods = torch.nn.ModuleDict({
        k: torch.nn.ParameterDict({"w": torch.nn.Parameter(
            torch.from_numpy(v["w"].copy()))}) for k, v in tree.items()})
    jopt = JaxOpt(tree)
    jstate = jopt.init(tree)
    opt = MultiOptimizer(mods)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    for _ in range(3):
        grads = {k: {"w": rng.standard_normal(v["w"].shape)
                     .astype(np.float32)} for k, v in tree.items()}
        params, jstate = jopt.step_modules(
            ("decoder", "mpd"), jax.tree_util.tree_map(jnp.asarray, grads),
            jstate, params)
        for k in tree:
            mods[k]["w"].grad = torch.from_numpy(grads[k]["w"])
            opt.step(k)
    for k in tree:
        np.testing.assert_allclose(mods[k]["w"].detach().numpy(),
                                   np.asarray(params[k]["w"]), rtol=1e-5,
                                   atol=1e-7)
    st = opt.state_trees()
    assert st["decoder"]["count"] == 3
    fresh = MultiOptimizer(mods)
    fresh.load_state_trees(st)
    assert fresh.state_trees()["mpd"]["count"] == 3


def test_onecycle_matches_optax():
    import optax

    from styletts2_tpu_torch.optim import onecycle_lr

    sched = optax.cosine_onecycle_schedule(100, 1e-3, 0.3, 10.0, 100.0)
    for step in (0, 7, 30, 31, 64, 99, 100, 150):
        # optax evaluates the cosine in f32, the port in f64
        assert onecycle_lr(step, 1e-3, 100, 0.3, 10.0, 100.0) == \
            pytest.approx(float(sched(step)), rel=1e-4)
    assert onecycle_lr(5, 1e-4, 100) == 1e-4  # the reference's config


def test_ada_snake_conv_is_inference_only():
    """B1's wrapper raises when asked to build a graph, naming the training
    route; under no_grad / inference_mode (the engine) it runs as before."""
    from styletts2_tpu_torch.nn import blocks as TB
    from styletts2_tpu_torch.ops import vocoder_kernel as VK

    blk = TB.AdaINResBlock1(32, 3, (1, 3), 16)
    blk.prepack(torch.float32)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((1, 40, 32)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((1, 16)).astype(np.float32))
    nv = torch.tensor([33], dtype=torch.int32)
    mask = torch.arange(40)[None, :] < nv[:, None]
    with pytest.raises(RuntimeError, match="inference only.*no n_valid"):
        blk(x, s, mask, nv)
    with torch.no_grad():
        ref = blk(x, s, mask, nv)
    with torch.inference_mode():
        np.testing.assert_array_equal(blk(x, s, mask, nv).numpy(),
                                      ref.numpy())
    # the plain route (no mask, no n_valid) differentiates and never
    # reaches the wrapper
    calls = VK.ada_snake_conv.launches
    blk(x, s).sum().backward()
    assert blk.convs1[0].weight.grad is not None
    assert VK.ada_snake_conv.launches == calls


@pytest.mark.parametrize("f_idx,n_idx", [(0, 0), (1, 2), (2, 3)])
def test_smooth_f0n_matches_jax(monkeypatch, f_idx, n_idx):
    """The training-time F0/N box smoothing at each width pair, the JAX
    draw of the widths replaced by the given indices."""
    from styletts2_tpu.nn import decoder as JDE
    from styletts2_tpu_torch.nn import decoder as DE

    picks = iter((f_idx, n_idx))
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(next(picks)))
    rng = np.random.default_rng(10)
    f0 = rng.standard_normal((2, 40)).astype(np.float32)
    n = rng.standard_normal((2, 40)).astype(np.float32)
    want = JDE.smooth_f0n_train(jnp.asarray(f0), jnp.asarray(n),
                                jax.random.PRNGKey(0))
    got = DE.smooth_f0n(torch.from_numpy(f0), torch.from_numpy(n),
                        (1, 3, 7)[f_idx], (1, 3, 7, 15)[n_idx])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_matches_jax(train):
    """BatchNorm with JAX's semantics: running statistics in eval, this
    batch's statistics (running ones untouched) in train."""
    from styletts2_tpu.nn import layers as JL
    from styletts2_tpu_torch.nn import layers as L

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)  # NCHW
    p = {"weight": rng.standard_normal(5).astype(np.float32),
         "bias": rng.standard_normal(5).astype(np.float32),
         "running_mean": rng.standard_normal(5).astype(np.float32),
         "running_var": rng.random(5).astype(np.float32) + 0.5}
    bn = L.BatchNorm(5)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    got = bn(torch.from_numpy(x), train=train)
    want = JL.batch_norm_apply(p, jnp.asarray(x.transpose(0, 2, 3, 1)),
                               train=train)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(bn.running_mean.numpy(), p["running_mean"])


def test_data_pipeline_matches_jax(tmp_path):
    """The port's copy of the data pipeline: the same bins, batches (both
    samplers, two epochs) and collated arrays as styletts2_tpu/data."""
    from styletts2_tpu.data import loader as JLD
    from styletts2_tpu.text import build_symbol_dict as jax_symbols
    from styletts2_tpu_torch import audio as AUD
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.data import loader as LD
    from styletts2_tpu_torch.text import build_symbol_dict

    rng = np.random.default_rng(12)
    lines = []
    for i in range(9):
        n = 7000 + 3100 * (i % 3) + 50 * i
        AUD.write_wav(str(tmp_path / f"c{i}.wav"),
                      (rng.standard_normal(n) * 0.1).astype(np.float32))
        lines.append(f"c{i}.wav|hello world number {i}\n")
    sym = load_config({}).symbol
    for validation in (False, True):
        ours = LD.build_dataloader(lines, str(tmp_path),
                                   build_symbol_dict(sym), validation,
                                   batch_size=2, debug=False)
        ref = JLD.build_dataloader(lines, str(tmp_path), jax_symbols(sym),
                                   validation, batch_size=2, debug=False)
        for epoch in (0, 1):
            ours.sampler.set_epoch(epoch)
            ref.sampler.set_epoch(epoch)
            got, want = list(ours.sampler), list(ref.sampler)
            assert got == want and len(got) > 1
            for bin_id, idx in got:
                a = LD.collate(ours.dataset, idx, bin_id)
                b = JLD.collate(ref.dataset, idx, bin_id)
                for f in ("waves", "texts", "input_lengths", "mel_lengths"):
                    np.testing.assert_array_equal(getattr(a, f),
                                                  getattr(b, f))
