"""The port's checkpoint tools (strip_checkpoint, extend_tokens,
convert_to_torch) against the JAX package's, which must give the same
outputs exactly; the demo CLI and the gradio app's missing-gradio exit;
the WAV encoder of the HTTP server; and the launch count's thread
safety."""

import copy
import threading

import numpy as np
import pytest
import torch
import yaml

from styletts2_tpu.tools import convert_to_torch as JCT
from styletts2_tpu.tools import extend_tokens as JET
from styletts2_tpu.tools import strip_checkpoint as JST
from styletts2_tpu_torch import audio as AUD
from styletts2_tpu_torch import flac as TFL
from styletts2_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.models import build_inference_modules
from styletts2_tpu_torch.nn.asr import ASRCNN
from styletts2_tpu_torch.tools import app as TAPP
from styletts2_tpu_torch.tools import convert_to_torch as TCT
from styletts2_tpu_torch.tools import demo_infer as TDEMO
from styletts2_tpu_torch.tools import extend_tokens as TET
from styletts2_tpu_torch.tools import strip_checkpoint as TST
from styletts2_tpu_torch.tools.serve_http import wav_bytes
from test_torch_checkpoint_io import _assert_trees_equal
from test_torch_deploy import VOCOS, _parse_wav, _quantised_clip
from torch_istft_common import port_tree

torch.set_num_threads(1)


# ---------------------------------------------------------------------
# checkpoint tools
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A native checkpoint of the small Vocos config's four inference
    modules (convert_to_torch writes its decoder with new-style weight-norm
    keys) and a small aligner, with an optimizer entry, and the config's
    YAML."""
    root = tmp_path_factory.mktemp("tools")
    mp = load_config(copy.deepcopy(VOCOS)).model_params
    mods = build_inference_modules(mp)
    # the decoder without the shell's 1024-wide encode / decode blocks
    mods["decoder"] = torch.nn.ModuleDict(
        {k: m for k, m in mods["decoder"].named_children()
         if k not in ("encode", "decode")})
    net = {k: port_tree(m, seed=i) for i, (k, m) in enumerate(mods.items())}
    net["text_aligner"] = port_tree(ASRCNN(input_dim=80, hidden_dim=64,
                                           n_token=mp.n_token, n_layers=1,
                                           token_embedding_dim=64), 7)
    path = str(root / "in.ckpt")
    save_checkpoint(path, net, optimizer={"decoder": {"count": 2}},
                    iters=11, epoch=3, val_loss=0.5)
    (root / "config.yaml").write_text(yaml.safe_dump(VOCOS))
    return root, path


def _same_checkpoint(a, b):
    sa, sb = load_checkpoint(a), load_checkpoint(b)
    _assert_trees_equal(sa["net"], sb["net"])
    for k in ("optimizer", "iters", "epoch"):
        assert sa.get(k) == sb.get(k), k


@pytest.mark.parametrize("tool", ["strip_checkpoint", "extend_tokens"])
def test_checkpoint_tool_matches_jax(ckpt, tool, capsys):
    """The port's tool and the JAX package's, same flags, same input: the
    same checkpoint out (extend_tokens: the same numpy draws)."""
    root, path = ckpt
    flags = {"strip_checkpoint": [],
             "extend_tokens": ["--new-tokens", "5", "--seed", "3"]}[tool]
    port, jax_ = {"strip_checkpoint": (TST, JST),
                  "extend_tokens": (TET, JET)}[tool]
    outs = []
    for mod, name in ((port, "port"), (jax_, "jax")):
        out = str(root / f"{tool}_{name}.ckpt")
        mod.main(["--ckpt", path, "--out", out] + flags)
        outs.append(out)
    _same_checkpoint(*outs)
    state = load_checkpoint(outs[0])
    assert state["optimizer"] is None and state["iters"] == 11
    if tool == "extend_tokens":
        n = load_checkpoint(path)["net"]["text_encoder"]["embedding"][
            "weight"].shape[0]
        assert state["net"]["text_encoder"]["embedding"]["weight"].shape[
            0] == n + 5
    else:
        assert sorted(state["net"]) == ["decoder", "predictor",
                                        "style_encoder", "text_encoder"]


@pytest.mark.parametrize("strip", [False, True])
def test_convert_to_torch_matches_jax(ckpt, strip):
    root, path = ckpt
    outs = []
    for mod, name in ((TCT, "port"), (JCT, "jax")):
        out = str(root / f"{name}_{strip}.pth")
        mod.main(["--checkpoint", path, "--config",
                  str(root / "config.yaml"), "--out", out]
                 + (["--strip"] if strip else []))
        outs.append(torch.load(out, map_location="cpu", weights_only=False))
    got, want = outs
    assert {k: v for k, v in got.items() if k != "net"} == \
        {k: v for k, v in want.items() if k != "net"}
    assert sorted(got["net"]) == sorted(want["net"])
    for key in want["net"]:
        assert sorted(got["net"][key]) == sorted(want["net"][key])
        for name, t in want["net"][key].items():
            assert torch.equal(got["net"][key][name], t), name


def test_wav_bytes_roundtrip():
    wav = np.sin(np.linspace(0, 40, 2400)).astype(np.float32) * 0.5
    sr, pcm = _parse_wav(wav_bytes(wav, 24000))
    assert sr == 24000
    np.testing.assert_allclose(pcm / 32767.0, np.clip(wav, -1, 1),
                               atol=1.0 / 32000)


# ---------------------------------------------------------------------
# the demos
# ---------------------------------------------------------------------

def test_demo_infer_and_app(tmp_path, monkeypatch):
    """demo_infer writes the WAV of a FLAC reference voice on the CPU; the
    gradio app, with gradio missing, exits with the JAX app's message."""
    TFL.write_flac(str(tmp_path / "bob.flac"), _quantised_clip(2))
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(VOCOS))
    out = str(tmp_path / "out.wav")
    TDEMO.main(["--config", str(tmp_path / "c.yaml"), "--ref-wav",
                str(tmp_path / "bob.flac"), "--text", "hello there you",
                "--out", out, "--device", "cpu"])
    wav, sr = AUD.read_audio(out)
    assert sr == 24000 and wav.size > 8000 and np.isfinite(wav).all()
    assert np.abs(wav[4000:-4000]).max() > 0
    monkeypatch.setitem(__import__("sys").modules, "gradio", None)
    with pytest.raises(SystemExit, match="gradio is not installed"):
        TAPP.build_app(object(), str(tmp_path))


def test_launch_count_is_per_thread_and_exact():
    """ops/launch_count under contention: 8 threads (more than the tests'
    cores) add launches, half of them inside a recording (a capture), with
    a short switch interval; the count holds exactly the unrecorded ones,
    and each recording exactly its own thread's."""
    import sys

    from styletts2_tpu_torch.ops import launch_count as LC

    n_threads, n_adds = 8, 2000
    recorded = [None] * n_threads
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        LC.reset()

        def work(i):
            if i % 2:
                with LC.recording() as rec:
                    for _ in range(n_adds):
                        LC.add("k")
                recorded[i] = rec
            else:
                for _ in range(n_adds):
                    LC.add("k")
                LC.add_recorded({"k": 1})

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert LC.get("k") == (n_threads // 2) * (n_adds + 1)
    assert all(recorded[i] == {"k": n_adds} for i in range(1, n_threads, 2))
    LC.reset()


# ---------------------------------------------------------------------
# tools/profile_inference
# ---------------------------------------------------------------------

def test_profile_inference_prints_every_figure_and_runs_phase2(
        monkeypatch):
    """tools/profile_inference on tests/test_torch_engine.py's tiny
    HiFi-GAN engine at small buckets (token 24 with 20 real tokens, frame
    60 and 120, the decoder alone at 60), one timed call each: every
    figure's line in the JAX tool's wording (after the card's line), the
    evaluations that run B1's blocks counted, and each phase-2 call the
    tool makes (recorded by a spy on the engine's _phase2) fed by its
    phase 1 with every token fb // 24 frames, its PCM equal to that of
    this test's own seed-0 engine on the same inputs."""
    import re

    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.tools import profile_inference as PI
    from test_torch_engine import CFG

    calls = {"phase1": [], "phase2": []}
    for name in calls:
        orig = getattr(StyleTTS2, f"_{name}")

        def spy(self, *a, _orig=orig, _rec=calls[name]):
            out = _orig(self, *a)
            _rec.append((a, out))
            return out

        monkeypatch.setattr(StyleTTS2, f"_{name}", spy)
    cfg = load_config(copy.deepcopy(CFG))
    lines = []
    out = PI.profile(cfg, "cpu", 1, token_bucket=24, n_tokens=20,
                     frame_buckets=(60, 120), decode_bucket=60,
                     style_seconds=3.0, reps=1, dispatch_reps=1,
                     log=lines.append)
    monkeypatch.undo()
    ms = r"\d+\.\d+ ms"
    want = [r"cpu", r"device: cpu", rf"dispatch overhead: {ms}",
            rf"B1 op call \(1, 1200, 256\): \d+\.\d{{3}} ms",
            rf"phase1 \(b=1, tb=24\): {ms}",
            rf"phase2 \(b=1, fb=60, 0\.3s audio\): {ms} -> [\d.]+x realtime",
            rf"phase2 \(b=1, fb=120, 0\.6s audio\): {ms} -> [\d.]+x realtime",
            rf"decoder-only \(b=1, fb=60\): {ms} -> [\d.]+x",
            rf"generator-only: {ms} -> [\d.]+x",
            rf"f0n-only \(b=1, fb=60\): {ms}"]
    assert len(lines) == len(want), lines
    for line, pat in zip(lines, want):
        assert re.fullmatch(pat, line), (line, pat)
    for key in ("dispatch_s", "b1_op_s", "phase1_s", "decoder_s",
                "generator_s", "f0n_s"):
        assert out[key] > 0, key
    assert sorted(out["phase2_s"]) == [60, 120]
    # 2 frame buckets x (warm + 1), the decoder and the generator x 2
    assert out["evals"] == 8 and out["b1_op_calls"] == 2

    engine = StyleTTS2(cfg, seed=0, device="cpu")
    (tokens, mask, s), (t_en, d, _) = calls["phase1"][0]
    assert tokens.shape == (1, 24) and int(mask.sum()) == 20
    # the untimed call, the warm call and one timed call
    assert len(calls["phase1"]) == 3 and len(calls["phase2"]) == 4
    for (args, got), fb in zip(calls["phase2"], (60, 60, 120, 120)):
        assert args[0] is t_en and args[1] is d and args[4] == fb
        durs = args[3]
        assert durs.shape == (1, 24) and bool((durs == fb // 24).all())
        assert got.shape == (1, 2 * fb * 60) and got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), engine._phase2(
            t_en, d, args[2], durs, fb).numpy())
