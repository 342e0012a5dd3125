"""The training slice against the JAX package at a tiny config: the eval
step's losses against a jitted `styletts2_tpu.train.eval_step_fn`, and the
D and G gradients against `make_grad_fns`, on the same weights (JAX's
`build_model` under PRNGKey(0), loaded into the port's modules) and
batch. JAX's random draws that the port cannot reproduce are fixed: the
crop starts and the sine source's phase and noise are derived from the
JAX key on the JAX side and handed to the port (`train.Draws`); for the
gradients, dropout and the aligner's unk masking are off on both sides and
the soft/mono coin is soft.

The data-parallel step over two CPU ranks (gloo subprocesses,
tests/torch_parallel_worker.py, started with the module so that they run
while JAX compiles) is held against the same JAX gradients, computed once
for both tests, and against one process's step on the global batch."""

import pickle

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
from torch_parallel_worker import collect, launch

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
KEY = 3


def step_input():
    """The global batch and the draws JAX's generator_forward makes under
    PRNGKey(KEY), as numpy. The rows' texts and mels differ in length
    (12 tokens / 50 half-mel frames, 9 / 45), so under data parallelism
    (one row per rank) loss_mono's normaliser needs the global maxima."""
    rng = np.random.default_rng(0)
    in_len = np.array([T_TEXT, T_TEXT - 3])
    mel_len = np.array([T_MEL, T_MEL - 10])
    keys = jax.random.split(jax.random.PRNGKey(KEY), 8)
    max_start = np.maximum(mel_len // 2 - CROP, 0)
    u = np.asarray(jax.random.uniform(keys[4], (B,)))
    _, k_gen = jax.random.split(keys[6])
    k_phase, k_noise = jax.random.split(jax.random.fold_in(k_gen, 0))
    rand_ini = np.array(jax.random.uniform(k_phase, (B, 9)))
    rand_ini[:, 0] = 0.0
    return {"cfg": TINY, "crop": CROP,
            "batch": {"waves": (rng.standard_normal((B, T_MEL * HOP)) * 0.1
                                ).astype(np.float32),
                      "texts": rng.integers(4, 170, (B, T_TEXT)),
                      "input_lengths": in_len, "mel_lengths": mel_len},
            "starts": np.minimum((u * (max_start + 1).astype(np.float32))
                                 .astype(np.int64), max_start),
            "rand_ini": rand_ini,
            "noise": np.asarray(jax.random.normal(
                k_noise, (B, 2 * CROP * HOP, 9)))}


@pytest.fixture(scope="module")
def jax_tree():
    """JAX's build_model(PRNGKey(0)) at TINY, as a numpy tree."""
    params = jax_build(jax.random.PRNGKey(0), jax_config(TINY).model_params)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory, jax_tree):
    """The data-parallel step (two ranks) and its single-process reference
    on step_input() and jax_tree, started at once. The tree (~340 MB) is
    written once for both groups and removed when they are done."""
    io = tmp_path_factory.mktemp("torch_dp_step")
    tree_file = io / "tree.pkl"
    with open(tree_file, "wb") as f:
        pickle.dump(jax_tree, f)
    inp = dict(step_input(), tree=str(tree_file))
    procs = {"step": launch("step", inp, io),
             "single": launch("single", inp, io, world=1)}
    yield io, procs
    for group in procs.values():
        for p in group:
            if p.poll() is None:
                p.kill()
                p.wait()
    tree_file.unlink(missing_ok=True)


@pytest.fixture(scope="module")
def setup(jax_tree, dp_runs):
    """(dp_runs first: the ranks run while JAX compiles.)"""
    torch.set_num_threads(1)
    jcfg = jax_config(TINY)
    cfg = load_config(TINY)
    tree = jax_tree
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    mods = build_model(cfg.model_params)
    W.split_weight_norm(mods)
    W.load_param_tree(mods, tree, fuse=False)
    mods.train()
    mods["pitch_extractor"].eval()

    inp = step_input()
    b = inp["batch"]
    jbatch = JT.Batch(jnp.asarray(b["waves"]),
                      jnp.asarray(b["texts"], jnp.int32),
                      jnp.asarray(b["input_lengths"], jnp.int32),
                      jnp.asarray(b["mel_lengths"], jnp.int32))
    tbatch = TT.Batch(*(torch.tensor(b[k]) for k in
                        ("waves", "texts", "input_lengths", "mel_lengths")))
    draws = TT.Draws(starts=torch.tensor(inp["starts"]),
                     source=(torch.tensor(inp["rand_ini"]),
                             torch.tensor(inp["noise"])))
    return jcfg, cfg, params, mods, jbatch, tbatch, jax.random.PRNGKey(KEY), \
        draws


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


@pytest.fixture(scope="module")
def jax_grads(setup):
    """JAX's make_grad_fns on the setup's weights, batch and key, dropout
    and the unk mask off, the coin soft: ((d_loss, d grads), (metrics, g
    grads))."""
    import styletts2_tpu.nn.layers as JL

    jcfg, cfg, params, mods, jbatch, tbatch, key, draws = setup
    orig_uniform = jax.random.uniform

    def uniform(k, shape=(), *a, **kw):
        if tuple(shape) == (B, T_TEXT):  # the unk mask: no token masked
            return jnp.ones(shape)
        return orig_uniform(k, shape, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "dropout", lambda x, rate, train, rng: x)
        mp.setattr(jax.random, "uniform", uniform)
        # with dropout off, bernoulli draws only the coin: soft attention
        mp.setattr(jax.random, "bernoulli",
                   lambda *a, **kw: jnp.asarray(True))
        d_fn, g_fn = JT.make_grad_fns(jcfg, CROP)
        return jax.jit(lambda p, b, k: (d_fn(p, b, k), g_fn(p, b, k)))(
            params, jbatch, key)


def _flat_jax(mods, k, tree):
    """A JAX gradient tree of module k, flattened in the port's parameter
    order."""
    flat = jax_flat(jax.tree_util.tree_map(np.asarray, tree))
    return np.concatenate([np.asarray(flat[n]).ravel()
                           for n, _ in mods[k].named_parameters()])


def test_dg_gradients_match_jax(setup, jax_grads):
    """Per module rel-l2 of the D gradients (mpd, msd) and the G gradients
    (the five generator modules) < 5e-3, losses rel < 1e-3."""
    jcfg, cfg, params, mods, jbatch, tbatch, key, draws = setup
    (jd_loss, jd_g), (jmet, jg_g) = jax_grads
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
            a = _flat_jax(mods, k, jg[k])
            b = np.concatenate([g.numpy().ravel() for g in tg[k]])
            rel = np.linalg.norm(a - b) / np.linalg.norm(a)
            print(f"{k}: grad rel-l2 {rel:.2e}")
            assert rel < 5e-3, (k, rel)


def test_dp_step_matches_jax_and_single_process(setup, jax_grads, dp_runs):
    """2 ranks x 1 row, draws fixed, dropout off: the rank-averaged D and
    G gradients == JAX make_grad_fns on the global batch (losses rel <
    1e-3, gradients rel-l2 < 5e-3 per module: test_dg_gradients_match_jax's
    gates); the parameters after one data-parallel step == one
    single-process step on the global batch (rtol 2e-3, atol 3e-4:
    tests/test_parallel.py's), bit-identical on both ranks. With every
    draw made, the ranks' per-row draws differ and the coin and the
    generator's state agree."""
    mods = setup[3]
    (jd_loss, jd_g), (jmet, jg_g) = jax_grads
    io, procs = dp_runs
    r0, r1 = collect(procs["step"], "step", io)
    (single,) = collect(procs["single"], "single", io)

    assert r0["local_rows"] == r1["local_rows"] == B // 2
    met = r0["metrics"]
    assert met == r1["metrics"]
    assert _rel(jd_loss, met["d_loss"]) < 1e-3
    for k in jmet:
        assert _rel(jmet[k], met[k]) < 1e-3, (k, float(jmet[k]), met[k])
    for jg in (jd_g, jg_g):
        for k in jg:
            np.testing.assert_array_equal(r0["grads"][k], r1["grads"][k])
            a = _flat_jax(mods, k, jg[k])
            rel = np.linalg.norm(a - r0["grads"][k]) / np.linalg.norm(a)
            print(f"{k}: grad rel-l2 {rel:.2e}")
            assert rel < 5e-3, (k, rel)
    for k, want in single["params"].items():
        np.testing.assert_array_equal(r0["params_dp"][k], r1["params_dp"][k])
        np.testing.assert_allclose(r0["params_dp"][k], want, rtol=2e-3,
                                   atol=3e-4, err_msg=k)
    assert r0["first_draw"].shape == r1["first_draw"].shape
    assert not np.array_equal(r0["first_draw"], r1["first_draw"])
    assert r0["n_row_draws"] == r1["n_row_draws"] > 0
    assert r0["coins"] == r1["coins"] and len(r0["coins"]) == 1
    np.testing.assert_array_equal(r0["gen_state"], r1["gen_state"])
