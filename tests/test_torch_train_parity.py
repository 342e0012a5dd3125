"""The training slice against the JAX package at a tiny config: the eval
step's losses against a jitted `styletts2_tpu.train.eval_step_fn`, and the
D and G gradients against `make_grad_fns`, on the same converted weights
and batch. JAX's random draws that the port cannot reproduce are fixed:
the crop starts and the sine source's phase and noise are derived from the
JAX key on the JAX side and handed to the port (`train.Draws`); for the
gradients, dropout and the aligner's unk masking are off on both sides and
the soft/mono coin is soft."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styletts2_tpu import train as JT
from styletts2_tpu.config import load_config as jax_config
from styletts2_tpu.convert import tree_to_state_dict as jax_flat
from styletts2_tpu.models import build_model as jax_build
from styletts2_tpu_torch import train as TT
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.models import build_model

# the composed_train module sizes (styletts2_tpu/tools/golden.py) with the
# quick tier's 60x decoder at hop 60 (prod(rates) == hop)
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
B, T_TEXT, T_MEL, CROP, HOP = 2, 12, 100, 33, 60


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    jcfg = jax_config(TINY)
    cfg = load_config(TINY)
    params = jax_build(jax.random.PRNGKey(0), jcfg.model_params)
    mods = build_model(cfg.model_params)
    W.split_weight_norm(mods)
    W.load_param_tree(mods, jax.tree_util.tree_map(np.asarray, params),
                      fuse=False)
    mods.train()
    mods["pitch_extractor"].eval()

    rng = np.random.default_rng(0)
    waves = (rng.standard_normal((B, T_MEL * HOP)) * 0.1).astype(np.float32)
    texts = rng.integers(4, 170, (B, T_TEXT))
    in_len = np.array([T_TEXT, T_TEXT - 3])
    mel_len = np.array([T_MEL, T_MEL - 10])
    jbatch = JT.Batch(jnp.asarray(waves), jnp.asarray(texts, jnp.int32),
                      jnp.asarray(in_len, jnp.int32),
                      jnp.asarray(mel_len, jnp.int32))
    tbatch = TT.Batch(torch.tensor(waves), torch.tensor(texts),
                      torch.tensor(in_len), torch.tensor(mel_len))

    # the draws of styletts2_tpu.train.generator_forward under this key
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 8)
    max_start = np.maximum(mel_len // 2 - CROP, 0)
    u = np.asarray(jax.random.uniform(keys[4], (B,)))
    starts = np.minimum((u * (max_start + 1).astype(np.float32))
                        .astype(np.int64), max_start)
    _, k_gen = jax.random.split(keys[6])
    k_phase, k_noise = jax.random.split(jax.random.fold_in(k_gen, 0))
    rand_ini = np.array(jax.random.uniform(k_phase, (B, 9)))
    rand_ini[:, 0] = 0.0
    noise = np.asarray(jax.random.normal(k_noise, (B, 2 * CROP * HOP, 9)))
    draws = TT.Draws(starts=torch.tensor(starts),
                     source=(torch.tensor(rand_ini), torch.tensor(noise)))
    return jcfg, cfg, params, mods, jbatch, tbatch, key, draws


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(a))


def test_eval_step_losses_match_jax(setup):
    jcfg, cfg, params, mods, jbatch, tbatch, key, draws = setup
    want = jax.jit(JT.eval_step_fn(jcfg, CROP))(params, jbatch, key)
    got = TT.eval_step_fn(cfg, CROP)(mods, tbatch, None, draws)
    assert set(got) == set(want)
    for k in want:
        assert _rel(want[k], got[k]) < 1e-3, (k, float(want[k]),
                                              float(got[k]))


def test_dg_gradients_match_jax(setup, monkeypatch):
    """Per module rel-l2 of the D gradients (mpd, msd) and the G gradients
    (the five generator modules) < 5e-3, losses rel < 1e-3."""
    import styletts2_tpu.nn.layers as JL

    jcfg, cfg, params, mods, jbatch, tbatch, key, draws = setup
    orig_uniform = jax.random.uniform

    def uniform(k, shape=(), *a, **kw):
        if tuple(shape) == (B, T_TEXT):  # the unk mask: no token masked
            return jnp.ones(shape)
        return orig_uniform(k, shape, *a, **kw)

    monkeypatch.setattr(JL, "dropout", lambda x, rate, train, rng: x)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    # with dropout off, bernoulli draws only the coin: soft attention
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda *a, **kw: jnp.asarray(True))
    d_fn, g_fn = JT.make_grad_fns(jcfg, CROP)
    (jd_loss, jd_g), (jmet, jg_g) = jax.jit(
        lambda p, b, k: (d_fn(p, b, k), g_fn(p, b, k)))(params, jbatch, key)

    fixed = TT.Draws(coin=True, starts=draws.starts, source=draws.source,
                     dropout=False)
    pd, pg = TT.make_grad_fns(cfg, CROP)
    d_loss, d_g = pd(mods, tbatch, None, fixed)
    met, g_g = pg(mods, tbatch, None, fixed)
    assert _rel(jd_loss, d_loss) < 1e-3
    for k in jmet:
        assert _rel(jmet[k], met[k]) < 1e-3, (k, float(jmet[k]),
                                              float(met[k]))
    for jg, tg in ((jd_g, d_g), (jg_g, g_g)):
        assert set(jg) == set(tg)
        for k in tg:
            flat = jax_flat(jax.tree_util.tree_map(np.asarray, jg[k]))
            names = [n for n, _ in mods[k].named_parameters()]
            a = np.concatenate([np.asarray(flat[n]).ravel() for n in names])
            b = np.concatenate([g.numpy().ravel() for g in tg[k]])
            rel = np.linalg.norm(a - b) / np.linalg.norm(a)
            print(f"{k}: grad rel-l2 {rel:.2e}")
            assert rel < 5e-3, (k, rel)
