"""The serving export (styletts2_tpu_torch/tools/export_serving.py) and
kernel B1 as a dispatcher operator (ops/vocoder_kernel.py), on the CPU.

The port's engine on the tiny HiFi-GAN config of tests/test_torch_engine.py
is built from the JAX package's build_model parameters and exported at
the one bucket pair (24, 60). A fresh interpreter that imports torch and
the operator module only loads the graphs with `load_exported` and runs
them; its outputs are held against JAX's jitted `_phase1` and `_phase2`
(the engine's `_phase2_impl`) and against the live port engine. The CUDA
kernel behind the op is checked on the card by chip_smoke.py (phase 13)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from styletts2_tpu.config import load_config as jax_load_config
from styletts2_tpu.infer import StyleTTS2 as JaxStyleTTS2
from styletts2_tpu.models import build_model
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.infer import StyleTTS2
from styletts2_tpu_torch.ops import vocoder_kernel as VK
from styletts2_tpu_torch.tools import export_serving as ES

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# the tiny config of tests/test_torch_engine.py
CFG = {
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
TB, FB = 24, 60
TOKENS = [1, 40, 50, 60, 2]  # tests/test_export.py's
DURS = [3, 4, 5, 6, 2]  # 20 frames
EDGE = 200  # PCM samples left out at each end of the JAX comparison
P1 = f"phase1/{TB}"
P2 = f"phase2/{TB}/{FB}"

# a process with no model code: torch, numpy and the operator module
# (through load_exported); it loads the graphs, runs phase 1, then phase 2
# on its own phase-1 outputs and on JAX's, and counts the B1 nodes
_CHILD = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)  # the parent's: CPU reductions split by thread
from styletts2_tpu_torch.tools.export_serving import load_exported
from styletts2_tpu_torch.ops import vocoder_kernel as VK
out, p1, p2 = sys.argv[1:4]
manifest, graphs = load_exported(out)
x = {k: torch.from_numpy(v) for k, v in np.load(out + "/inputs.npz").items()}
t_en, d, dur = graphs[p1](x["tokens"], x["mask"], x["s"])
pcm = graphs[p2](t_en, d, x["s"], x["durs"])
pcm_jax_in = graphs[p2](x["jax_t_en"], x["jax_d"], x["s"], x["durs"])
nodes = graphs[p2].module.graph.nodes
np.savez(out + "/outputs.npz", t_en=t_en.numpy(), d=d.numpy(),
         dur=dur.numpy(), pcm=pcm.numpy(), pcm_jax_in=pcm_jax_in.numpy(),
         b1_nodes=sum(1 for n in nodes if n.target is VK.OP))
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith(("styletts2_tpu", "jax")))))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Export, then the child process's run beside JAX's and the live
    engine's on the same inputs (JAX's phase 2 compiles while the child
    runs). The ~0.16 GB of graph files are removed at the end, whatever
    happened."""
    out = tmp_path_factory.mktemp("export")
    try:
        return _export_and_run(out)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _export_and_run(out):
    jcfg = jax_load_config(CFG)
    params = jax.tree.map(np.asarray,
                          build_model(jax.random.PRNGKey(0), jcfg.model_params))
    port = StyleTTS2(load_config(CFG), params=params, seed=0, device="cpu")
    manifest = ES.export_engine(port, str(out), [TB], [FB])
    jax_engine = JaxStyleTTS2(jcfg, params=params, seed=0)

    tokens = np.zeros((1, TB), np.int64)
    tokens[0, : len(TOKENS)] = TOKENS
    mask = np.zeros((1, TB), bool)
    mask[0, : len(TOKENS)] = True
    s = np.full((1, 32), 0.1, np.float32)
    durs = np.zeros((1, TB), np.int32)
    durs[0, : len(DURS)] = DURS
    jax1 = [np.asarray(a) for a in jax_engine._phase1(
        jax_engine.params, tokens.astype(np.int32), mask, s)]
    np.savez(out / "inputs.npz", tokens=tokens, mask=mask, s=s, durs=durs,
             jax_t_en=jax1[0], jax_d=jax1[1])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(out), P1, P2], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jax2 = np.asarray(jax_engine._phase2(
            jax_engine.params, jax1[0], jax1[1], s, durs, n_frames=FB))
        tt = {k: torch.from_numpy(v) for k, v in
              (("tokens", tokens), ("mask", mask), ("s", s), ("durs", durs))}
        live1 = [a.numpy() for a in port._phase1(tt["tokens"], tt["mask"],
                                                 tt["s"])]
        live2 = port._phase2(torch.from_numpy(live1[0]),
                             torch.from_numpy(live1[1]), tt["s"],
                             tt["durs"], FB).numpy()
        stdout, stderr = child.communicate(timeout=300)
    finally:
        child.kill()
    assert child.returncode == 0, stderr
    got = dict(np.load(out / "outputs.npz"))
    sizes = {f: os.path.getsize(out / f) for f in os.listdir(out)}
    manifest_json = json.loads((out / "manifest.json").read_text())
    return dict(manifest=manifest, manifest_json=manifest_json, sizes=sizes,
                got=got, jax1=jax1, jax2=jax2, live1=live1, live2=live2,
                modules=json.loads(stdout.strip().splitlines()[-1]),
                port=port)


def _b1_args(dtype, residual, seed=0, b=2, t=37, c=32, k=3):
    rng = np.random.default_rng(seed)

    def rnd(*shape, sc=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * sc).astype(np.float32))

    return dict(x=rnd(b, t, c).to(dtype), scale=rnd(b, c, sc=0.5) + 1.0,
                shift=rnd(b, c, sc=0.1), alpha=rnd(c).abs() + 0.5,
                w=rnd(k, c, c, sc=0.1).to(dtype), bias=rnd(c, sc=0.01),
                n_valid=torch.tensor([t - 9 * i for i in range(b)],
                                     dtype=torch.int32),
                residual=rnd(b, t, c).to(dtype) if residual else None)


_CASES = [(dt, res, st) for dt in (torch.float32, torch.bfloat16)
          for res in (False, True) for st in (False, True)]


def test_op_cpu_kernel_is_the_plain_version():
    """The registered op on CPU tensors, and the wrapper that calls it,
    equal ada_snake_conv_plain exactly (f32 and bf16, with and without the
    residual and the stats); without stats the op's second output is
    empty."""
    for dtype, res, st in _CASES:
        a = _b1_args(dtype, res)
        want = VK.ada_snake_conv_plain(*list(a.values())[:6], 3,
                                       a["n_valid"], residual=a["residual"],
                                       out_stats=st)
        out, stats = VK.OP(*list(a.values())[:6], 3, a["n_valid"],
                           a["residual"], st)
        wrapped = VK.ada_snake_conv(*list(a.values())[:6], 3, a["n_valid"],
                                    residual=a["residual"], out_stats=st)
        if st:
            torch.testing.assert_close(out, want[0], rtol=0, atol=0)
            torch.testing.assert_close(stats, want[1], rtol=0, atol=0)
            for w, g in zip(want, wrapped):
                torch.testing.assert_close(g, w, rtol=0, atol=0)
        else:
            torch.testing.assert_close(out, want, rtol=0, atol=0)
            torch.testing.assert_close(wrapped, want, rtol=0, atol=0)
            assert stats.shape == (0,) and stats.dtype == torch.float32


def test_fake_kernel_gives_the_real_shapes_and_dtypes():
    """Under a FakeTensorMode (what torch.export traces with) the op's
    outputs have the CPU kernel's shapes, dtypes and device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for dtype, res, st in _CASES:
        a = _b1_args(dtype, res, b=3, t=41, c=64, k=5)
        real = VK.OP(*list(a.values())[:6], 5, a["n_valid"], a["residual"],
                     st)
        with FakeTensorMode() as mode:
            fa = {k: None if v is None else mode.from_tensor(v)
                  for k, v in a.items()}
            fake = VK.OP(*list(fa.values())[:6], 5, fa["n_valid"],
                         fa["residual"], st)
        for r, f in zip(real, fake):
            assert (tuple(f.shape), f.dtype, f.device) == (
                tuple(r.shape), r.dtype, r.device)


def test_manifest_matches_the_jax_tool(run):
    """The manifest has the JAX tool's keys, file names (.pt2 for
    .stablehlo) and fields (styletts2_tpu/tools/export_serving.py
    export_engine); the engine refuses a mesh, and the CLI wants an
    output."""
    assert run["manifest"] == {P1: f"phase1_t{TB}.pt2",
                               P2: f"phase2_t{TB}_f{FB}.pt2"}
    m = run["manifest_json"]
    assert sorted(m) == ["graphs", "hop", "sr", "style_dim"]
    assert m["graphs"] == run["manifest"]
    port = run["port"]
    assert (m["sr"], m["hop"], m["style_dim"]) == (port.sr, port.hop, 32)
    assert sorted(run["sizes"]) == sorted(
        ["manifest.json", "inputs.npz", "outputs.npz",
         *run["manifest"].values()])
    mesh_engine = type("E", (), {"mesh": object(), "seq_parallel": False})
    with pytest.raises(ValueError, match="single-device"):
        ES.export_engine(mesh_engine, "unused", [TB], [FB])
    with pytest.raises(SystemExit):
        ES.main(["--config", "unused.yaml"])


def test_cli_takes_the_jax_tools_form_and_the_voicepack_form(
        tmp_path, monkeypatch):
    """The JAX tool's command line (`--config c.yaml --out dir
    --token-buckets 64 --frame-buckets 200`) hands --out to export_engine
    as the graphs directory with the parsed buckets; `--voices-dir D --out
    pack.npz` writes the voicepack there and exports nothing, and with
    `--graphs-out G` also exports to G; without --voices-dir, --out and
    --graphs-out together are refused. The engine and both writers are
    stand-ins: the export itself is held against the JAX tool's manifest
    above."""
    calls = []

    class Engine:
        def __init__(self, config, ckpt=None, device="cuda"):
            calls.append(("engine", config, ckpt, device))

    import styletts2_tpu_torch.infer as INF

    def export_engine(engine, out, tbs, fbs):
        calls.append(("export", type(engine), out, tbs, fbs))
        return {}

    def save_voicepack(engine, out, voices, denoise):
        calls.append(("voicepack", type(engine), out, voices, denoise))

    monkeypatch.setattr(INF, "StyleTTS2", Engine)
    monkeypatch.setattr(ES, "export_engine", export_engine)
    monkeypatch.setattr(ES, "save_voicepack", save_voicepack)
    (tmp_path / "voices").mkdir()
    (tmp_path / "voices" / "a.wav").write_bytes(b"")
    voices = {"a": str(tmp_path / "voices" / "a.wav")}

    ES.main(["--config", "c.yaml", "--out", "dir", "--token-buckets", "64",
             "--frame-buckets", "200", "--device", "cpu"])
    assert calls == [("engine", "c.yaml", None, "cpu"),
                     ("export", Engine, "dir", [64], [200])]
    calls.clear()
    ES.main(["--config", "c.yaml", "--voices-dir", str(tmp_path / "voices"),
             "--out", "pack.npz", "--device", "cpu"])
    assert calls == [("engine", "c.yaml", None, "cpu"),
                     ("voicepack", Engine, "pack.npz", voices, 0.3)]
    calls.clear()
    ES.main(["--config", "c.yaml", "--voices-dir", str(tmp_path / "voices"),
             "--out", "pack.npz", "--graphs-out", "g", "--device", "cpu"])
    assert calls[1:] == [("export", Engine, "g", [64, 128], [200, 400, 800]),
                         ("voicepack", Engine, "pack.npz", voices, 0.3)]
    calls.clear()
    with pytest.raises(SystemExit):
        ES.main(["--config", "c.yaml", "--out", "dir", "--graphs-out", "g",
                 "--device", "cpu"])
    assert calls == []


def test_phase1_graph_matches_jax(run):
    """The loaded phase-1 graph against JAX's jitted _phase1 on the same
    parameters, tokens [1, 40, 50, 60, 2] and s = 0.1 (tests/test_export.py's
    atol 1e-5 / rtol 1e-4)."""
    got = run["got"]
    for name, want in zip(("t_en", "d", "dur"), run["jax1"]):
        np.testing.assert_allclose(got[name], want, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_phase2_graph_matches_jax(run):
    """The loaded phase-2 graph on JAX's phase-1 outputs against JAX's
    phase 2 at pinned durations [3, 4, 5, 6, 2]: int16 PCM rel-l2 < 5e-4
    (test_torch_engine.py::test_waveform_matches_with_pinned_durations)
    over the samples the engine keeps (2 * hop per frame of the total),
    less EDGE at each end: the engine trims 4000 there, and an unvoiced
    random-weight generator drives the first and last ~100 samples of a
    chunk to large values that move ~4e-3 between the packages."""
    got, want = run["got"]["pcm_jax_in"], run["jax2"]
    assert got.dtype == want.dtype == np.int16
    assert got.shape == want.shape == (1, 2 * FB * 60)
    n = 2 * sum(DURS) * 60  # the samples the engine keeps
    mid = slice(EDGE, n - EDGE)
    want = want[0, mid].astype(np.float64)
    assert np.abs(want).max() > 0
    err = _rel_l2(got[0, mid].astype(np.float64), want)
    assert err < 5e-4, err


def test_phase2_graph_holds_b1_per_adain_pair(run):
    """One B1 op node per AdaIN+Snake+conv pair of the generator: two per
    dilation of every AdaINResBlock1 (the resblocks and the noise_res
    blocks), derived from the config."""
    dec = load_config(CFG).model_params.decoder
    assert int(run["got"]["b1_nodes"]) == chip_smoke.b1_per_eval(dec) > 0


def test_graphs_equal_the_live_engine(run):
    """The loaded graphs against the live port engine's _phase1 and
    _phase2 on the same inputs: identical."""
    got = run["got"]
    for name, want in zip(("t_en", "d", "dur"), run["live1"]):
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    np.testing.assert_array_equal(got["pcm"], run["live2"])


def test_loading_process_imports_no_model_code(run):
    """The child imported the operator module and no model code: no
    styletts2_tpu_torch.nn, .infer or .models, and nothing of JAX."""
    mods = run["modules"]
    assert "styletts2_tpu_torch.ops.vocoder_kernel" in mods
    bad = [m for m in mods
           if m.startswith(("styletts2_tpu_torch.nn", "styletts2_tpu_torch."
                            "infer", "styletts2_tpu_torch.models", "jax",
                            "styletts2_tpu."))
           or m == "styletts2_tpu"]
    assert not bad, bad
