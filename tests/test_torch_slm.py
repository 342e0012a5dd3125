"""The port's SLM adversarial round against the JAX package on the CPU, at
the tiny model config of tests/test_torch_train_parity.py and the small
WavLM of tests/test_torch_wavlm.py (which holds the stage's other parts
and `train_loop` with `slmadv_params`): the soft alignment, and one
round's losses and gradients with the sine source's draws fixed."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styletts2_tpu import losses as JLO
from styletts2_tpu.config import load_config as jax_config
from styletts2_tpu.nn import decoder as JDE
from styletts2_tpu.nn import predictor as JPR
from styletts2_tpu.nn import slm as JSLM
from styletts2_tpu.nn import style_encoder as JSE
from styletts2_tpu.nn import text_encoder as JTE
from styletts2_tpu.nn import wavlm as JWL
from styletts2_tpu.nn.discriminators import wavlm_d_init
from styletts2_tpu.ops import stft as JOPS
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.models import build_inference_modules
from styletts2_tpu_torch.nn import slm as SLM
from styletts2_tpu_torch.nn import wavlm as WL
from styletts2_tpu_torch.nn.discriminators import WavLMDiscriminator
from styletts2_tpu_torch.optim import MultiOptimizer

from test_torch_train_parity import TINY
from test_torch_wavlm import carried, rel_l2, small_cfgs

torch.set_num_threads(1)
B_, T_TEXT, T_MEL, CROP, HOP = 2, 12, 100, 33, 60


def test_soft_alignment_matches_jax():
    """Max abs < 1e-6, a padded token in row 1."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 7, 10)).astype(np.float32) * 2
    mask = np.arange(7)[None, :] < np.array([[7], [5]])
    want = JSLM.soft_alignment_from_durations(jnp.asarray(logits),
                                              jnp.asarray(mask), 40)
    got = SLM.soft_alignment_from_durations(torch.from_numpy(logits),
                                            torch.from_numpy(mask), 40)
    assert got.shape == (2, 7, 40)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6


@pytest.fixture(scope="module")
def slm_round():
    """The tiny model (port weights carried into JAX), the small WavLM and
    head (JAX weights carried into the port), a batch, and the sine
    source's draws that JAX's decoder_apply takes from its key."""
    raw = copy.deepcopy(TINY)
    raw["slmadv_params"] = {"enabled": True}
    jcfg, cfg = jax_config(copy.deepcopy(raw)), load_config(raw)
    mods = build_inference_modules(cfg.model_params)  # a round's modules
    W.init_random(mods, torch.Generator().manual_seed(3))
    W.split_weight_norm(mods)
    params = {k: jax.tree.map(jnp.asarray, W.module_tree(m))
              for k, m in mods.items()}
    jw, _ = small_cfgs()
    wparams = JWL.init(jax.random.PRNGKey(7), jw)
    wd_tree = wavlm_d_init(jax.random.PRNGKey(8), slm_hidden=96,
                           slm_layers=4)
    wavlm = carried(wparams, WL.WavLM(small_cfgs()[1])).eval()
    wd = WavLMDiscriminator(96, 4)
    W.split_weight_norm(wd)
    carried(wd_tree, wd)
    trainer = SLM.SLMAdversarialTrainer(
        cfg, MultiOptimizer(mods), SLM.LO.WavLMLoss(
            wavlm.requires_grad_(False), wd))

    rng = np.random.default_rng(0)
    waves = (rng.standard_normal((B_, T_MEL * HOP)) * 0.1).astype(np.float32)
    texts = rng.integers(4, 170, (B_, T_TEXT))
    lens = np.array([T_TEXT, T_TEXT - 3])
    key = jax.random.PRNGKey(5)

    @jax.jit
    def draws(key):  # decoder_apply -> the HiFi-GAN source -> sine_gen
        k_phase, k_noise = jax.random.split(jax.random.fold_in(
            jax.random.split(key)[1], 0))
        return (jax.random.uniform(k_phase, (B_, 9)),
                jax.random.normal(k_noise, (B_, 2 * CROP * HOP, 9)))

    rand_ini, noise = (np.array(a) for a in draws(key))
    rand_ini[:, 0] = 0.0
    return dict(jcfg=jcfg, params=params, wparams=wparams, jw=jw,
                wd_tree=wd_tree, mods=mods, trainer=trainer, waves=waves,
                texts=texts, lens=lens, key=key,
                source=(torch.tensor(rand_ini), torch.tensor(noise)))


def test_slm_round_matches_jax(slm_round):
    """One round against JAX's SLMAdversarialLoss, as SLMAdversarialTrainer
    builds it: the generator step's scaled loss and the discriminator
    step's, rel < 1e-3; the head's gradients, rel-l2 < 5e-3. The generator
    step's gradients are held by the chain rule at the decoder's input
    (asr, F0, N), because at this point JAX's own decoder-shell gradients
    move by ~1-2% when those inputs move by 1e-6 (a kink of the random
    reference, shown by JAX alone): the decoder's, and the cotangents it
    sends back, against JAX's decoder and loss at the port's decoder
    inputs; the predictor's against JAX's front half (generator_step's
    text encoder to F0/N, at JAX's own inputs) pulled back along the
    port's cotangents. Each rel-l2 < 5e-3."""
    r = slm_round
    jcfg, sp = r["jcfg"], r["jcfg"].preprocess_params.spect_params
    mp, scale = jcfg.model_params, jcfg.slmadv_params.scale
    wl = JLO.WavLMLoss(JWL.make_embedder(r["wparams"], r["jw"]), r["wd_tree"])
    slm = JSLM.SLMAdversarialLoss(wl, sig=jcfg.slmadv_params.sig)
    jtexts = jnp.asarray(r["texts"], jnp.int32)
    jlens = jnp.asarray(r["lens"], jnp.int32)
    jwaves = jnp.asarray(r["waves"])

    def ref_s_of(params):
        mels = JOPS.preprocess_wave(jwaves, sr=24000, n_fft=sp.n_fft,
                                    win_length=sp.win_length,
                                    hop_length=sp.hop_length,
                                    n_mels=mp.n_mels)
        return JSE.apply(params["style_encoder"], mels)

    def front(pred, params):
        """generator_step up to the decoder: (asr, F0, N)."""
        mask = jnp.arange(T_TEXT)[None, :] < jlens[:, None]
        t_en = JTE.apply(params["text_encoder"], jtexts, mask)
        ref_s = ref_s_of(params)
        d = JPR.encode_duration(pred, t_en, ref_s, mask)
        dur = JPR.duration_head(pred, d, mask)
        attn_t = jnp.swapaxes(JSLM.soft_alignment_from_durations(
            dur, mask, CROP, slm.sig), 1, 2)
        total = jnp.minimum((jax.nn.sigmoid(dur).sum(-1) * mask).sum(1),
                            CROP)
        fm = jnp.arange(CROP)[None, :] < total[:, None]
        f0, n = JPR.f0n_train(pred, attn_t @ d, ref_s, mask=fm,
                              out_mask=jnp.repeat(fm, 2, axis=1))
        return attn_t @ t_en, f0, n

    def back(dec, asr, f0, n, s, fm):
        y = JDE.decoder_apply(dec, mp.decoder, asr, f0, n, s, rng=r["key"],
                              frame_mask=fm)
        return wl.generator(y[..., 0]) * scale

    def d_fn(wd, y):
        return slm.discriminator_step(jwaves[:, : CROP * 2 * HOP], y[..., 0],
                                      wd_params=wd)

    tr, mods = r["trainer"], r["mods"]
    texts, lens = torch.from_numpy(r["texts"]), torch.from_numpy(r["lens"])
    waves = torch.from_numpy(r["waves"])
    # the port's decoder inputs, and the cotangents its loss sends to them
    inputs, cots = [], {}

    def keep(mod, args):
        inputs.extend(args[:5])  # asr, F0, N, style, frame mask
        for i in range(3):
            args[i].register_hook(lambda g, i=i: cots.__setitem__(i, g))

    hook = mods["decoder"].register_forward_pre_hook(keep)
    g_loss, y, g = tr.generator_grads(mods, texts, lens, waves, CROP,
                                      r["source"])
    hook.remove()
    cots = [cots[i] for i in range(3)]
    d_loss, d = tr.discriminator_grads(waves, y, CROP)

    @jax.jit
    def jax_side(params, wd, inputs, cots):
        g_loss, y = slm.generator_step(params, mp, jtexts, jlens,
                                       ref_s_of(params), CROP, r["key"])
        d_loss, d = jax.value_and_grad(d_fn)(wd, y)
        dec, *in_cots = jax.grad(back, argnums=(0, 1, 2, 3))(
            params["decoder"], *inputs)
        _, pull = jax.vjp(lambda p: front(p, params), params["predictor"])
        return g_loss * scale, y, d_loss, d, dec, in_cots, pull(cots)[0]

    jg_loss, jy, jd_loss, jd, jdec, jcots, jpred = jax_side(
        r["params"], r["wd_tree"],
        [jnp.asarray(t.detach().numpy()) for t in inputs],
        tuple(jnp.asarray(c.numpy()) for c in cots))
    assert y.shape == jy.shape == (B_, 2 * CROP * HOP, 1)
    for name, a, b in (("slm_g", g_loss, jg_loss), ("slm_d", d_loss,
                                                     jd_loss)):
        assert abs(a.item() - float(b)) < 1e-3 * abs(float(b)), \
            (name, float(b), a.item())
    for name, a, b in zip(("asr", "F0", "N"), cots, jcots):
        assert rel_l2(a.numpy(), b) < 5e-3, (name, rel_l2(a.numpy(), b))
    for key, got, want, module in (
            ("predictor", g["predictor"], jpred, mods["predictor"]),
            ("decoder", g["decoder"], jdec, mods["decoder"]),
            ("wavlm_d", d, jd, tr.wl.wd)):
        flat = W.tree_to_state_dict(jax.tree.map(np.asarray, want),
                                    fuse=False)
        names = [k for k, _ in module.named_parameters()]
        a = np.concatenate([t.numpy().ravel() for t in got])
        b = np.concatenate([flat[k].numpy().ravel() for k in names])
        assert rel_l2(a, b) < 5e-3, (key, rel_l2(a, b))
    assert all(p.grad is None for m in mods.values() for p in m.parameters())
