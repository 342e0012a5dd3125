"""The correctness check has to fail what is wrong: the control (the
reference at the precisions below the configuration's), and a run whose
timed path is broken underneath. CPU, tiny configuration; the run skips
only the harness's look for a chip."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import cells
from benchmark.harness.traffic import Texts, alphabet
from benchmark.reference import frontend as FE
from benchmark.reference import params as P
from benchmark.reference import synth as S
from benchmark.reference.model import Reference
from conftest import make_root, tiny_config

SEED = 2 ** 31 + 11


def run(tmp_path, workload, mix, decoder="hifigan"):
    root = make_root(tmp_path, [(workload, decoder, mix)])
    return cells.run_cell(cells.load(root, workload), SEED, 0.5, False, "cpu",
                          time.perf_counter())


def test_sound_run_is_correct(tmp_path):
    out = run(tmp_path, "tiny.interactive", "tiny_interactive")
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


def test_control_fails(monkeypatch):
    """The reference with float8 decoder operands (and TF32, which a CPU
    ignores) in the program's place: its audio misses the f32 reference
    by more than the tiny cell's limit."""
    cfg = tiny_config()
    symbols = FE.symbol_dict(cfg["symbol"])
    w = P.make_weights(P.spec(cfg["model_params"], len(symbols) + 1), 3,
                       "cpu")
    ref, ctl = Reference(cfg, w, "cpu"), Reference(cfg, w, "cpu", "control")
    s = ref.style(np.random.default_rng(0).standard_normal(36000)
                  .astype(np.float32) * 0.1)
    text = Texts({"sentences": [1, 1], "words": [6, 6], "letters": [4, 6]},
                 alphabet(cfg["symbol"]), 1).text()
    raw = ref.phase1(FE.tokens(text, symbols), s)[2]
    scale = 4.0 / float(raw.mean())
    want = S.plan_text(ref, text, s, scale, 17, 0, 16)
    got = S.plan_text(ctl, text, s, scale, 17, 0, 16)
    pcm = ctl.phase2(got[0].t_en, got[0].d, s, got[0].pred)
    z = np.zeros(S.EDGE, np.float32)
    wav = np.concatenate([z, pcm[S.EDGE:-S.EDGE] / 32767.0, z])
    v = S.compare(ref, want, s, wav.astype(np.float32))
    assert not v.length_ok or v.err_rms > 1e-3, v


def _alter_pcm(monkeypatch):
    from styletts2_tpu_torch import infer

    orig = infer.StyleTTS2._decode

    def decode(self, *a, **k):
        pcm = orig(self, *a, **k)
        return (pcm.to(torch.int32) + 300).clamp(-32768, 32767).to(
            torch.int16)

    monkeypatch.setattr(infer.StyleTTS2, "_decode", decode)


def _alter_durations(monkeypatch):
    from styletts2_tpu_torch import infer

    orig = infer._device_postprocess_durations

    def host(self, *a, **k):
        pred, mean = orig_host(self, *a, **k)
        pred = pred.copy()
        pred[1] += 1
        return pred, mean

    orig_host = infer.StyleTTS2._postprocess_durations
    monkeypatch.setattr(infer, "_device_postprocess_durations",
                        lambda *a, **k: _one_more(orig, *a, **k))
    monkeypatch.setattr(infer.StyleTTS2, "_postprocess_durations", host)


def _one_more(orig, *a, **k):
    pred, total = orig(*a, **k)
    pred = pred.clone()
    pred[:, 1] += 1
    return pred, pred.sum(dim=1, dtype=torch.int32)


def _stale_answer(monkeypatch):
    from styletts2_tpu_torch import infer

    orig = infer.StyleTTS2.generate
    last = {}

    def generate(self, *a, **k):
        wav = orig(self, *a, **k)
        prev = last.get("wav", wav)
        last["wav"] = wav
        return prev

    monkeypatch.setattr(infer.StyleTTS2, "generate", generate)


def _half_batch(monkeypatch):
    from styletts2_tpu_torch import infer

    orig = infer.StyleTTS2._phase2

    def phase2(self, t_en, d, s, durs, n_frames):
        b = t_en.shape[0]
        if b >= 2:
            idx = torch.arange(b) % (b // 2)
            t_en, d, durs = t_en[idx], d[idx], durs[idx]
        return orig(self, t_en, d, s, durs, n_frames)

    monkeypatch.setattr(infer.StyleTTS2, "_phase2", phase2)


@pytest.mark.parametrize("fault,workload,mix", [
    (_alter_pcm, "tiny.interactive", "tiny_interactive"),
    (_alter_durations, "tiny.interactive", "tiny_interactive"),
    (_stale_answer, "tiny.interactive", "tiny_interactive"),
    (_alter_pcm, "tiny.serve", "tiny_serve"),
    (_alter_durations, "tiny.serve", "tiny_serve"),
    (_half_batch, "tiny.serve", "tiny_serve"),
], ids=["pcm", "durations", "stale", "serve-pcm", "serve-durations",
        "serve-half-batch"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault,
                                            workload, mix):
    fault(monkeypatch)
    out = run(tmp_path, workload, mix)
    assert not out["correct"], out["checks"]
