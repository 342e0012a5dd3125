"""The port's data-parallel engine over two CPU ranks (gloo, subprocesses:
tests/torch_parallel_worker.py) against the single-device engine, both
started together in the module's fixture, and the entry points' device
checks. The data-parallel D/G step is held against JAX's gradients in
tests/test_torch_train_parity.py, which computes them once for the
single-process and the data-parallel step (`train_loop --distributed`:
tests/test_torch_parallel_loop.py)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parallel_worker import collect, launch

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)

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


def _engine_input():
    rng = np.random.default_rng(11)
    return {"cfg": ENGINE_CFG,
            "ref_wav": (rng.standard_normal(24000 * 3) * 0.1).astype(
                np.float32),
            "dp": {"text": "one two three. four five six. seven eight.",
                   "texts": [f"speak part {i} now." for i in range(5)],
                   "fixed": 4}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The data-parallel engine and its single-device reference, started
    at once."""
    io = tmp_path_factory.mktemp("torch_parallel")
    inp = _engine_input()
    procs = {"engine": launch("engine", inp, io),
             "single_engine": launch("single_engine", inp, io, world=1)}
    yield io, procs
    for group in procs.values():
        for p in group:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_dp_engine_matches_single_device(runs):
    """generate (three chunks: phase-1 rows padded to 4, phase-2 groups of
    2 and of 1 padded to 2) and generate_batch on five texts (4 + a
    padded tail of 1 -> 2) against the single-device engine, atol 2e-4
    (tests/test_infer.py's mesh tests); every rank returns the same audio
    and the batch buckets are (2, 4, 8)."""
    io, procs = runs
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
