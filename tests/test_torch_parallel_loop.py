"""`train_loop --distributed` of the port over two CPU ranks (gloo,
subprocesses: tests/torch_parallel_worker.py), with the SLM stage on."""

import numpy as np
import torch

from torch_parallel_worker import collect, launch

torch.set_num_threads(1)

LOOP_MODEL = """
model_params:
  hidden_dim: 64
  max_conv_dim: 64
  dim_in: 16
  style_dim: 32
  max_dur: 10
  ASR_params: {input_dim: 80, hidden_dim: 64, n_layers: 2,
               token_embedding_dim: 64}
  decoder: {type: vocos, num_layers: 2, intermediate_dim: 256,
            gen_istft_n_fft: 1200, gen_istft_hop_size: 300}
slmadv_params: {enabled: true, allow_random_wavlm: true, iter: 1}
tpu:
  decoder_dtype: float32
"""
# tests/test_torch_wavlm.py's small WavLM
SMALL_WAVLM = dict(hidden_size=96, num_hidden_layers=3, num_attention_heads=4,
                   intermediate_size=128, num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4, num_buckets=64,
                   max_bucket_distance=100, conv_dim=(48,) * 7)

TEXTS = ["the quick brown", "brown fox jumps", "jumps over a",
         "a lazy dog sleeps in the sun ok",  # 33 tokens, the others <= 17
         "dog while eager", "eager cats watch"]
SAMPLES = [7000, 7400, 7800, 9300, 8600, 9000]  # 23-31 mel frames: bin 0


def _workspace(root):
    """A tiny workspace: 6 clips in one duration bin (4 to train: one step
    of 2 rows per rank; 2 to validate: one row per rank), a seed
    checkpoint, the config. Whichever rank draws the 33-token text pads
    its texts to 64, the other to 32."""
    from styletts2_tpu_torch import audio as AUD
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.checkpoint import save_checkpoint
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.models import build_model

    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    lines = []
    for i, (n, text) in enumerate(zip(SAMPLES, TEXTS)):
        AUD.write_wav(str(root / "wavs" / f"clip{i}.wav"),
                      (rng.standard_normal(n) * 0.1).astype(np.float32))
        lines.append(f"wavs/clip{i}.wav|{text}\n")
    (root / "train_list.txt").write_text("".join(lines[:4]))
    (root / "val_list.txt").write_text("".join(lines[4:]))
    seed, config = root / "seed.ckpt", root / "config.yaml"
    config.write_text(f"""
log_dir: "{root / 'runs'}"
save_freq: 1
log_interval: 1
epochs: 1
batch_size: 2
max_len: 66
pretrained_model: "{seed}"
load_only_params: true
debug: false
data_params:
  train_data: "{root / 'train_list.txt'}"
  val_data: "{root / 'val_list.txt'}"
  root_path: "{root}"
""" + LOOP_MODEL)
    mods = build_model(load_config(str(config)).model_params)
    W.init_random(mods, torch.Generator().manual_seed(42))
    W.split_weight_norm(mods)
    save_checkpoint(str(seed), mods)
    return {"config": str(config), "wavlm": SMALL_WAVLM,
            "dist_url": f"file://{root / 'loop_dist_store'}"}


def test_train_loop_distributed_two_ranks(tmp_path):
    """`train_loop --distributed` over 2 ranks, one epoch of the tiny
    workspace (one step of 2 rows per rank, the SLM round after it, one
    eval row per rank; the small Vocos decoder at the data pipeline's
    hop 300, the cheapest on the CPU): the ranks draw disjoint rows
    covering the training list (tests/test_multihost.py's counterpart);
    their loaders pad the texts to different widths, and still the
    soft/mono coins and the generator's state agree; their parameters and
    optimizer states (the SLM head's included) are bit-identical at the
    end, and only rank 0 wrote the epoch checkpoint (the workers record
    the writes instead of making them: each would be ~1 GB)."""
    procs = launch("loop", _workspace(tmp_path), tmp_path)
    r0, r1 = collect(procs, "loop", tmp_path)
    (tmp_path / "seed.ckpt").unlink()  # ~300 MB
    assert r0["steps"] == r1["steps"] == 1
    assert r0["rounds"] == r1["rounds"] == 1
    assert set(r0["drawn"]).isdisjoint(r1["drawn"])
    assert sorted(r0["drawn"] + r1["drawn"]) == [0, 1, 2, 3]
    assert sorted(r0["text_widths"] + r1["text_widths"]) == [32, 64]
    assert r0["coins"] == r1["coins"] and len(r0["coins"]) == 2  # D and G
    np.testing.assert_array_equal(r0["gen_state"], r1["gen_state"])
    assert r0["metrics"] == r1["metrics"]  # averaged over the ranks
    assert r0["saved"] == ["epoch_00000.ckpt"] and r1["saved"] == []
    assert set(r0["state"]) == set(r1["state"])
    assert any(k.startswith("opt.decoder.mu") for k in r0["state"])
    assert any(k.startswith("wd_opt.") for k in r0["state"])
    for k, digest in r0["state"].items():
        assert digest == r1["state"][k], k
