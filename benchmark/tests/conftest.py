"""Tests of the benchmark: CPU tests at a tiny configuration, and `chip`
tests that need a CUDA device and skip without one."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
BENCH = ROOT / "benchmark"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip")
    return "cuda"


def tiny_config(decoder: str = "hifigan") -> dict:
    """The published configuration cut to CPU-test size: every width the
    decoder shell fixes kept, the rest small; hop 60 with HiFi-GAN rates
    [6, 10] so a frame is 120 samples."""
    cfg = json.loads((BENCH / "configs" / "styletts2-lite-hifigan.json")
                     .read_text())["config"]
    cfg = copy.deepcopy(cfg)
    cfg["model_params"].update(dim_in=8, hidden_dim=32, max_conv_dim=32,
                               n_layer=1, style_dim=16, max_dur=10)
    cfg["preprocess_params"] = {"sr": 24000, "spect_params": {
        "n_fft": 256, "win_length": 240, "hop_length": 60}}
    if decoder == "hifigan":
        cfg["model_params"]["decoder"] = dict(
            type="hifigan", resblock_kernel_sizes=[3], upsample_rates=[6, 10],
            upsample_initial_channel=512, resblock_dilation_sizes=[[1, 3]],
            upsample_kernel_sizes=[12, 20])
    else:
        cfg["model_params"]["decoder"] = dict(
            type="vocos", gen_istft_n_fft=240, gen_istft_hop_size=60,
            intermediate_dim=64, num_layers=2)
    cfg["tpu"] = {"decoder_dtype": "float32"}
    cfg["debug"] = False
    return cfg


TINY_MIXES = {
    "tiny_interactive": {
        "kind": "generate", "sentences": [1, 1], "words": [4, 6],
        "letters": [3, 8], "n_merge": 16, "stabilize": True, "speed": 1.0,
        "frames_per_token": 4.0, "warmup_requests": 2, "settle_requests": 1,
        "plan_requests": 20, "keep_share": 0.5, "sample": 2,
        "trace_requests": 2},
    "tiny_serve": {
        "kind": "serve", "batch": 2, "sentences": [2, 3], "words": [5, 7],
        "letters": [3, 8], "n_merge": 8, "stabilize": True, "speed": 1.0,
        "frames_per_token": 4.0, "warmup_batches": 1, "keep_share": 0.5,
        "sample": 2, "trace_batches": 1},
}


def make_root(tmp_path: Path, cells, limits=None) -> Path:
    """A checkout-like root: the repo's BENCHMARK.json with tiny configs
    and mixes added, and a copy of benchmark/ holding their files.
    cells: [(workload, decoder, mix)]."""
    root = tmp_path / "root"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for wl, dec, mix in cells:
        name = f"tiny-{dec}"
        path = root / "benchmark" / "configs" / f"{name}.json"
        path.write_text(json.dumps({"name": name, "config": tiny_config(dec)}))
        if all(c["name"] != name for c in bench["configs"]):
            bench["configs"].append({
                "name": name, "source": "test", "reduced": [], "why": "test",
                "file": f"benchmark/configs/{name}.json"})
        (root / "benchmark" / "traffic" / f"{mix}.json").write_text(
            json.dumps(TINY_MIXES[mix]))
        (root / "benchmark" / "limits" / f"{wl}.json").write_text(json.dumps(
            limits or {"style_gap": 1e-4, "length_mismatch": 0,
                       "pcm_rms_err": 1e-3}))
        bench["workloads"].append({"name": wl, "config": name,
                                   "traffic": mix, "chips": 1, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and (
                    (mix.endswith("interactive") and
                     any(w.endswith("interactive") for w in m["workloads"]))
                    or (mix.endswith("serve") and
                        any(w.endswith("serve_b16") for w in m["workloads"]))):
                m["workloads"].append(wl)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
