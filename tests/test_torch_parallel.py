"""The port's data-parallel engine and step over two CPU ranks (gloo,
subprocesses: tests/torch_parallel_worker.py): the engine with a mesh
against the single-device engine, the data-parallel D/G step against
JAX's gradients on the global batch and against one process's step
(`train_loop --distributed`: tests/test_torch_parallel_loop.py). The
worker groups and their one-process references start together in the
module's fixture; the step test, first, computes JAX's gradients while
they run."""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parallel_worker import collect, launch, train_tree

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)

# tests/test_torch_engine.py's tiny engine config (hop 60, rates [10, 6])
ENGINE_CFG = {
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


# tests/test_torch_train_parity.py's tiny training config and batch, one
# row per rank: the ranks' longest text and mel differ (rank 0: 12 tokens
# / 50 half-mel frames, rank 1: 9 / 45), so loss_mono's normaliser needs
# the global maxima
TRAIN_TINY = {
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
IN_LEN = np.array([T_TEXT, T_TEXT - 3])
MEL_LEN = np.array([T_MEL, T_MEL - 10])


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(a))


def _engine_input():
    rng = np.random.default_rng(11)
    return {"cfg": ENGINE_CFG,
            "ref_wav": (rng.standard_normal(24000 * 3) * 0.1).astype(
                np.float32),
            "dp": {"text": "one two three. four five six. seven eight.",
                   "texts": [f"speak part {i} now." for i in range(5)],
                   "fixed": 4}}


def _step_input():
    """The global batch, the weights (drawn by the port, JAX layout) and
    the draws JAX's generator_forward makes under PRNGKey(3)
    (tests/test_torch_train_parity.py's derivation)."""
    import jax

    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    max_start = np.maximum(MEL_LEN // 2 - CROP, 0)
    u = np.asarray(jax.random.uniform(keys[4], (B,)))
    _, k_gen = jax.random.split(keys[6])
    k_phase, k_noise = jax.random.split(jax.random.fold_in(k_gen, 0))
    rand_ini = np.array(jax.random.uniform(k_phase, (B, 9)))
    rand_ini[:, 0] = 0.0
    return {"cfg": TRAIN_TINY, "crop": CROP,
            "batch": {"waves": (rng.standard_normal((B, T_MEL * HOP)) * 0.1
                                ).astype(np.float32),
                      "texts": rng.integers(4, 170, (B, T_TEXT)),
                      "input_lengths": IN_LEN, "mel_lengths": MEL_LEN},
            "starts": np.minimum((u * (max_start + 1).astype(np.float32))
                                 .astype(np.int64), max_start),
            "rand_ini": rand_ini,
            "noise": np.asarray(jax.random.normal(
                k_noise, (B, 2 * CROP * HOP, 9)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every worker group started at once."""
    io = tmp_path_factory.mktemp("torch_parallel")
    inputs = {"engine": _engine_input(), "step": _step_input()}
    procs = {m: launch(m, inp, io) for m, inp in inputs.items()}
    procs["single_engine"] = launch("single_engine", inputs["engine"], io,
                                    world=1)
    procs["single"] = launch("single", inputs["step"], io, world=1)
    yield io, procs, inputs
    for group in procs.values():
        for p in group:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_dp_step_matches_jax_and_single_process(runs, monkeypatch):
    """2 ranks x 1 row, draws fixed, dropout off: the rank-averaged D and
    G gradients == JAX make_grad_fns on the global batch (losses rel <
    1e-3, gradients rel-l2 < 5e-3 per module: test_torch_train_parity.py's
    gates); the parameters after one data-parallel step == one
    single-process step on the global batch (rtol 2e-3, atol 3e-4:
    tests/test_parallel.py's), bit-identical on both ranks. With every
    draw made, the ranks' per-row draws differ and the coin and the
    generator's state agree."""
    import jax
    import jax.numpy as jnp

    import styletts2_tpu.nn.layers as JL
    from styletts2_tpu import train as JT
    from styletts2_tpu.config import load_config as jax_config
    from styletts2_tpu.convert import tree_to_state_dict as jax_flat
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.models import build_model

    io, procs, inputs = runs
    inp = inputs["step"]
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
    b = inp["batch"]
    jbatch = JT.Batch(jnp.asarray(b["waves"]),
                      jnp.asarray(b["texts"], jnp.int32),
                      jnp.asarray(b["input_lengths"], jnp.int32),
                      jnp.asarray(b["mel_lengths"], jnp.int32))
    d_fn, g_fn = JT.make_grad_fns(jax_config(TRAIN_TINY), CROP)
    # the weights the ranks draw from the same seed
    params = jax.tree_util.tree_map(jnp.asarray, train_tree(TRAIN_TINY))
    (jd_loss, jd_g), (jmet, jg_g) = jax.jit(
        lambda p, b, k: (d_fn(p, b, k), g_fn(p, b, k)))(
            params, jbatch, jax.random.PRNGKey(3))
    r0, r1 = collect(procs["step"], "step", io)
    (single,) = collect(procs["single"], "single", io)

    assert r0["local_rows"] == r1["local_rows"] == B // 2
    met = r0["metrics"]
    assert met == r1["metrics"]
    assert _rel(jd_loss, met["d_loss"]) < 1e-3
    for k in jmet:
        assert _rel(jmet[k], met[k]) < 1e-3, (k, float(jmet[k]), met[k])
    mods = build_model(load_config(TRAIN_TINY).model_params)
    W.split_weight_norm(mods)
    for jg in (jd_g, jg_g):
        for k in jg:
            np.testing.assert_array_equal(r0["grads"][k], r1["grads"][k])
            flat = jax_flat(jax.tree_util.tree_map(np.asarray, jg[k]))
            a = np.concatenate([np.asarray(flat[n]).ravel()
                                for n, _ in mods[k].named_parameters()])
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


def test_dp_engine_matches_single_device(runs):
    """generate (three chunks: phase-1 rows padded to 4, phase-2 groups of
    2 and of 1 padded to 2) and generate_batch on five texts (4 + a
    padded tail of 1 -> 2) against the single-device engine, atol 2e-4
    (tests/test_infer.py's mesh tests); every rank returns the same audio
    and the batch buckets are (2, 4, 8)."""
    io, procs, inputs = runs
    (want,) = collect(procs["single_engine"], "single_engine", io)
    r0, r1 = collect(procs["engine"], "engine", io)
    assert r0["batch_buckets"] == (2, 4, 8)
    np.testing.assert_allclose(r0["style"], want["style"], atol=1e-5)
    np.testing.assert_array_equal(r0["wav"], r1["wav"])
    assert r0["wav"].shape == want["wav"].shape
    np.testing.assert_allclose(r0["wav"], want["wav"], atol=2e-4)
    # 5 pieces in one frame bucket: a group of 4 and the tail padded to 2
    assert r0["batch_phase2_calls"] == r1["batch_phase2_calls"] == 2
    assert len(r0["batch"]) == len(want["batch"]) == 5
    for got, other, ref in zip(r0["batch"], r1["batch"], want["batch"]):
        np.testing.assert_array_equal(got, other)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=2e-4)


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    """On a host without a GPU, init_distributed(), train_loop
    --distributed and a mesh engine raise unless the CPU is asked for;
    make_mesh needs a process group; shard_batch keeps a rank's rows."""
    from styletts2_tpu_torch import train_loop
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.parallel import (Mesh, init_distributed,
                                              make_mesh, shard_batch)

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_distributed()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_loop.main(["-p", str(REPO / "configs" /
                                       "config_example.yaml"),
                             "--distributed"])
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device="cpu")
    mesh = Mesh(None, 1, 2, "cpu")
    with pytest.raises(ValueError, match="on a mesh"):
        StyleTTS2(load_config(ENGINE_CFG), seed=0, mesh=mesh)
    x = torch.arange(8).reshape(4, 2)
    rows = shard_batch(mesh, {"x": x, "n": np.arange(4), "flag": True})
    assert torch.equal(rows["x"], x[2:]) and list(rows["n"]) == [2, 3]
    assert rows["flag"] is True
    assert torch.equal(shard_batch(mesh, x, local=True), x)
