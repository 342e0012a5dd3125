"""The port's finetune driver end to end on the CPU: `train_loop.main`
over a tiny synthetic dataset (six 0.3-s WAVs, one duration bin) with a
small model, a seed checkpoint the port writes itself, one epoch, the
eval pass and the epoch checkpoint. The checkpoint must load in the JAX
package (load_checkpoint + strict apply_checkpoint) and in the port's
inference engine, and resuming from it restores the counters."""

import os

import numpy as np
import pytest
import torch

import jax

from styletts2_tpu_torch import audio as AUD
from styletts2_tpu_torch import weights as W
from styletts2_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.models import build_model

torch.set_num_threads(1)
WORDS = ("the quick brown fox jumps over a lazy dog while eager cats "
         "watch from warm windows and dream of distant silver fish").split()

# a small model at the data pipeline's hop of 300 (prod(rates) == hop)
MODEL_YAML = """
model_params:
  hidden_dim: 64
  max_conv_dim: 64
  dim_in: 16
  style_dim: 32
  max_dur: 10
  ASR_params: {input_dim: 80, hidden_dim: 64, n_layers: 2,
               token_embedding_dim: 64}
  decoder:
    type: hifigan
    upsample_initial_channel: 512
    upsample_rates: [5, 5, 4, 3]
    upsample_kernel_sizes: [10, 10, 8, 6]
    resblock_kernel_sizes: [3]
    resblock_dilation_sizes: [[1, 3]]
tpu:
  decoder_dtype: float32
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Six ~0.3 s WAVs (bin 0), list files, a seed checkpoint, the config."""
    root = tmp_path_factory.mktemp("torch_train_cli")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i in range(6):
        n = 7000 + 400 * i  # 23-32 mel frames raw -> all in bin 0
        AUD.write_wav(str(root / "wavs" / f"clip{i}.wav"),
                      (rng.standard_normal(n) * 0.1).astype(np.float32))
        lines.append(f"wavs/clip{i}.wav|{' '.join(WORDS[3 * i: 3 * i + 3])}\n")
    (root / "train_list.txt").write_text("".join(lines[:2]))
    (root / "val_list.txt").write_text("".join(lines[4:]))

    log_dir = root / "runs"
    seed_ckpt = root / "seed.ckpt"
    config_path = root / "config.yaml"
    config_path.write_text(f"""
log_dir: "{log_dir}"
save_freq: 1
log_interval: 1
epochs: 1
batch_size: 2
max_len: 66
pretrained_model: "{seed_ckpt}"
load_only_params: true
debug: false
data_params:
  train_data: "{root / 'train_list.txt'}"
  val_data: "{root / 'val_list.txt'}"
  root_path: "{root}"
""" + MODEL_YAML)
    cfg = load_config(str(config_path))
    mods = build_model(cfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(42))
    W.split_weight_norm(mods)
    save_checkpoint(str(seed_ckpt), mods)
    return root, str(config_path), str(log_dir), str(seed_ckpt)


def test_train_cli_one_epoch_saves_and_logs(workspace):
    from styletts2_tpu_torch.train_loop import main

    root, config_path, log_dir, seed_ckpt = workspace
    trainer = main(["-p", config_path, "--nan-action", "raise"],
                   device="cpu")
    assert len(trainer.history) == 1 and len(trainer.evals) == 1
    assert all(isinstance(v, float) and np.isfinite(v)
               for v in trainer.history[0]["metrics"].values())

    ckpt_path = os.path.join(log_dir, "epoch_00000.ckpt")
    state = load_checkpoint(ckpt_path)
    assert state["iters"] == 1 and state["epoch"] == 0
    assert state["optimizer"]["decoder"]["count"] == 1
    seed = load_checkpoint(seed_ckpt)
    moved = np.max(np.abs(
        state["net"]["text_encoder"]["embedding"]["weight"]
        - seed["net"]["text_encoder"]["embedding"]["weight"]))
    assert moved > 0
    for a, b in zip(jax.tree_util.tree_leaves(state["net"]["pitch_extractor"]),
                    jax.tree_util.tree_leaves(seed["net"]["pitch_extractor"])):
        np.testing.assert_array_equal(a, b)

    assert os.path.exists(os.path.join(log_dir, "train.log"))
    names = os.listdir(os.path.join(log_dir, "tensorboard"))
    assert any(n.startswith("events.out.tfevents.") for n in names)
    assert any(n.endswith(".jsonl") for n in names)
    assert os.path.exists(os.path.join(log_dir, "config.yaml"))


def test_checkpoint_loads_in_jax_and_in_the_engine(workspace):
    """The port's epoch checkpoint through the JAX package's own loader
    (strict shapes, every key of a freshly built tree) and into the port's
    CPU inference engine, which then synthesises."""
    from styletts2_tpu.checkpoint import (apply_checkpoint,
                                          load_checkpoint as jax_load)
    from styletts2_tpu.config import load_config as jax_config
    from styletts2_tpu.models import build_model as jax_build
    from styletts2_tpu_torch.infer import StyleTTS2

    root, config_path, log_dir, _ = workspace
    ckpt_path = os.path.join(log_dir, "epoch_00000.ckpt")
    state = jax_load(ckpt_path)
    fresh = jax_build(jax.random.PRNGKey(0),
                      jax_config(config_path).model_params)
    loaded = apply_checkpoint(fresh, state, strict_shapes=True)
    np.testing.assert_array_equal(
        np.asarray(loaded["decoder"]["generator"]["conv_post"]["weight_v"]),
        state["net"]["decoder"]["generator"]["conv_post"]["weight_v"])

    engine = StyleTTS2(config_path, models_path=ckpt_path, device="cpu")
    engine.fused_enabled = False
    ref_s = engine.compute_style(
        (np.random.default_rng(1).standard_normal(36000) * 0.1)
        .astype(np.float32), denoise=0.0)
    wav = engine.generate("ðə kwɪk bɹaʊn fɑːks.",
                          {"style": ref_s, "speed": 1.0})
    assert wav.size > 0 and np.all(np.isfinite(wav))


def test_train_cli_resume_restores_counters(workspace):
    from styletts2_tpu_torch.train_loop import main

    root, config_path, log_dir, _ = workspace
    ckpt_path = os.path.join(log_dir, "epoch_00000.ckpt")
    base = (root / "config.yaml").read_text()
    resume_cfg = root / "resume.yaml"
    resume_cfg.write_text(
        base.replace(f'pretrained_model: "{root / "seed.ckpt"}"',
                     f'pretrained_model: "{ckpt_path}"')
            .replace("load_only_params: true", "load_only_params: false")
            .replace("log_interval: 1", "log_interval: 5")
            .replace(f'log_dir: "{log_dir}"',
                     f'log_dir: "{log_dir}_resume"'))
    trainer = main(["-p", str(resume_cfg)], device="cpu")
    # no log point in the one step: its losses are fetched at the epoch's end
    (h,) = trainer.history
    assert h["step"] == 2
    assert all(isinstance(v, float) and np.isfinite(v)
               for v in h["metrics"].values())
    resumed = load_checkpoint(
        os.path.join(f"{log_dir}_resume", "epoch_00000.ckpt"))
    assert resumed["iters"] == 2  # 1 restored + 1 new step
    assert resumed["optimizer"]["decoder"]["count"] == 2


def test_train_cli_requires_pretrained_and_a_device(workspace):
    from styletts2_tpu_torch.train_loop import main

    root, config_path, _, _ = workspace
    bad = root / "nopretrain.yaml"
    bad.write_text((root / "config.yaml").read_text()
                   .replace('pretrained_model: "', 'x_ignored: "'))
    with pytest.raises(RuntimeError, match="Must have a pretrained"):
        main(["-p", str(bad)], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-p", config_path])


def test_nan_action_raise_and_ignore(workspace):
    """--nan-action: 'raise' stops on a non-finite loss, 'ignore' lets it
    pass; there is no 'skip' (the check follows the step's updates)."""
    from styletts2_tpu_torch.profiling import NonFiniteLossError, check_finite
    from styletts2_tpu_torch.train_loop import main

    bad = {"mel": 0.5, "gen": float("nan")}
    with pytest.raises(NonFiniteLossError, match="gen"):
        check_finite(bad, 3, "raise")
    check_finite(bad, 3, "ignore")
    check_finite({"mel": 0.5}, 3, "raise")
    with pytest.raises(SystemExit):
        main(["-p", workspace[1], "--nan-action", "skip"], device="cpu")


def _bench_config(batch, max_len, decoder, remat, grad_accum):
    """tools/bench_train's config at this file's small model: MODEL_YAML's
    modules at hop 30 with a [6, 5] decoder (a tenth of the hop-300 step's
    samples; the generator's width and the discriminators are fixed)."""
    import yaml

    raw = yaml.safe_load(MODEL_YAML)
    raw.update(batch_size=batch, max_len=max_len, debug=False)
    raw["preprocess_params"] = {"spect_params": {
        "n_fft": 512, "win_length": 120, "hop_length": 30}}
    raw["model_params"]["decoder"].update(
        type=decoder, upsample_rates=[6, 5], upsample_kernel_sizes=[12, 10])
    raw["tpu"].update(remat=remat, grad_accum=grad_accum)
    return load_config(raw)


def test_bench_train_one_cpu_step(capsys, monkeypatch):
    """tools/bench_train through its command line at _bench_config (batch
    1, max_len 66; --steps 1 after the warm step, --device cpu): one JSON
    line with the JAX tool's keys and finite losses."""
    import json

    from styletts2_tpu_torch.tools import bench_train as BT

    monkeypatch.setattr(BT, "bench_config", _bench_config)
    out = BT.main(["--batch", "1", "--max-len", "66", "--t-text", "12",
                   "--steps", "1", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"metric", "ms_per_step", "steps_per_s",
                         "mel_frames_per_s", "audio_s_per_train_s",
                         "compile_plus_first_step_s", "device", "losses",
                         "peak_mem_gib"}
    assert line["metric"] == "train step (hifigan, batch 1, max_len 66)"
    assert line["device"] == "cpu" and line["peak_mem_gib"] is None
    assert set(line["losses"]) == {"mel", "gen", "ce", "dur", "norm", "f0",
                                   "s2s", "mono", "g_loss", "d_loss"}
    assert all(np.isfinite(v) for v in line["losses"].values())
    assert line["ms_per_step"] > 0 and line["mel_frames_per_s"] > 0


def test_bench_train_batch_and_errors(monkeypatch):
    """tools/bench_train's batch is the JAX tool's numpy construction at
    seed 0 (styletts2_tpu/tools/bench_train.py:74-80, written out here);
    B2 runs 8 times per micro-batch of the warm and the timed steps; an
    error inside the step, out-of-memory among them, propagates (the
    batch is never shrunk)."""
    from styletts2_tpu_torch import train as TT
    from styletts2_tpu_torch.tools import bench_train as BT

    b, t_text, t_mel = 2, 7, 9
    rng = np.random.default_rng(0)
    want = dict(
        waves=rng.standard_normal((b, t_mel * 300)).astype("float32") * 0.1,
        texts=rng.integers(4, 170, (b, t_text)).astype("int32"),
        input_lengths=np.full((b,), t_text, np.int32),
        mel_lengths=np.full((b,), t_mel, np.int32))
    got = BT.synthetic_batch(b, t_text, t_mel, 300)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert BT.b2_launches(_bench_config(5, 66, "hifigan", False, 5), 3) == \
        8 * 5 * 4

    def oom(*a, **k):
        raise torch.OutOfMemoryError("out of memory (stand-in)")

    monkeypatch.setattr(TT, "make_step_pair", lambda *a, **k: (oom, oom))
    monkeypatch.setattr(W, "init_random", lambda *a, **k: None)
    with pytest.raises(torch.OutOfMemoryError, match="stand-in"):
        BT.run(_bench_config(1, 66, "hifigan", False, 1), "cpu", steps=1,
               t_text=12)
