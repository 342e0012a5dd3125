"""The port's serving path on the CPU against the JAX package's:
voicepacks both ways, the HTTP server's routes and errors (as
tests/test_serve_http.py holds the JAX server), with the server's audio
held bit for bit to the engine it serves, and background graph capture's
routing (as tests/test_quick_e2e.py holds the JAX engine's). The tools,
FLAC, the demos and the launch count are in test_torch_deploy_tools.py
and test_torch_deploy_flac.py: each of these files keeps fewer tests than
tests/test_seqpar.py, so that pytest-xdist's loadfile scheduling, which
hands out the files with the most tests first, still starts that long
file early."""

import base64
import copy
import io
import json
import threading
import urllib.error
import urllib.request
import wave as _wave

import numpy as np
import pytest
import torch

from styletts2_tpu.tools import export_serving as JES
from styletts2_tpu_torch import audio as AUD
from styletts2_tpu_torch import flac as TFL
from styletts2_tpu_torch.config import load_config
from styletts2_tpu_torch.infer import StyleTTS2
from styletts2_tpu_torch.tools import export_serving as TES
from styletts2_tpu_torch.tools.serve_http import (TTSService, make_server,
                                                  wav_bytes)
from test_torch_checkpoint_io import DECODERS
from torch_istft_common import config

torch.set_num_threads(1)
# the small Vocos config of the engine and the tools (HiFi-GAN's
# 512-channel generator takes ~1 s per call on two CPU threads, Vocos
# ~0.1 s)
VOCOS = config(DECODERS["vocos"])
FIXED = 6  # frames per token: chunks of 13-17 tokens fill the 120 bucket


def _quantised_clip(seed, n=24000 * 2):
    """A seeded clip whose 16-bit WAV and FLAC files hold the same samples
    (write_wav truncates x * 32767 in f32, write_flac in f64: every
    sample sits half a step from an integer, so both truncate alike)."""
    q = np.round(np.random.default_rng(seed).standard_normal(n) * 3276.7)
    return ((q + 0.5 * np.sign(q)) / 32767.0).astype(np.float32)


# ---------------------------------------------------------------------
# the engine behind the server
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    engine = StyleTTS2(load_config(copy.deepcopy(VOCOS)), seed=0,
                       device="cpu")
    engine.fixed_duration = FIXED
    return engine


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    """Two reference clips, one WAV and one FLAC."""
    root = tmp_path_factory.mktemp("voices")
    for name, fmt, seed in (("alice", "wav", 1), ("bob", "flac", 2)):
        x = _quantised_clip(seed)
        if fmt == "wav":
            AUD.write_wav(str(root / f"{name}.wav"), x)
        else:
            TFL.write_flac(str(root / f"{name}.flac"), x)
    return root


def test_voicepacks_cross_both_ways(engine, voices, tmp_path):
    """A pack the port writes loads in the JAX package, and one JAX's
    save_voicepack writes (here over the port's engine) loads in the port;
    the FLAC voice's style equals the same samples' from a WAV."""
    files = TES.voice_files(str(voices))
    assert sorted(files) == ["alice", "bob"]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    TES.save_voicepack(engine, ours, files, denoise=0.0)
    JES.save_voicepack(engine, theirs, files, denoise=0.0)
    for a, b in ((JES.load_voicepack(ours), TES.load_voicepack(theirs)),
                 (TES.load_voicepack(ours), JES.load_voicepack(theirs))):
        assert a[0] == b[0] == engine.symbol_dict
        assert sorted(a[1]) == sorted(b[1]) == ["alice", "bob"]
        for k in a[1]:
            assert a[1][k].shape == (1, 32)
            np.testing.assert_array_equal(a[1][k], b[1][k])
    wav = str(tmp_path / "bob.wav")
    AUD.write_wav(wav, _quantised_clip(2))
    np.testing.assert_array_equal(
        AUD.read_audio(wav)[0], AUD.read_audio(files["bob"])[0])
    np.testing.assert_array_equal(
        engine.compute_style(wav, denoise=0.0).numpy(),
        TES.load_voicepack(ours)[1]["bob"])


@pytest.fixture(scope="module")
def server(engine, voices, tmp_path_factory):
    pack = str(tmp_path_factory.mktemp("pack") / "pack.npz")
    TES.save_voicepack(engine, pack, {"carol": TES.voice_files(
        str(voices))["alice"]}, denoise=0.0)
    service = TTSService.build(engine, voicepack=pack,
                               voices_dir=str(voices), denoise=0.0)
    srv = make_server(service, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _parse_wav(data: bytes):
    with _wave.open(io.BytesIO(data)) as f:
        assert f.getnchannels() == 1 and f.getsampwidth() == 2
        return f.getframerate(), np.frombuffer(
            f.readframes(f.getnframes()), "<i2")


def test_health_and_voices(server):
    base, svc = server
    status, body, ctype = _get(base + "/health")
    assert status == 200 and ctype == "application/json"
    h = json.loads(body)
    assert h == {"ok": True, "sr": svc.engine.sr, "decoder": "vocos",
                 "n_voices": 3}
    assert json.loads(_get(base + "/voices")[1])["voices"] == [
        "alice", "bob", "carol"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/nothing")
    assert e.value.code == 404


def test_tts_returns_the_engines_wav(server):
    """/tts answers with the WAV of the engine's own generate, bit for bit;
    the voicepack's voice and the directory's clip of the same samples
    give the same audio."""
    base, svc = server
    engine = svc.engine
    bodies = []
    for voice in ("alice", "carol"):
        engine._rng = np.random.default_rng(4)
        status, body, ctype = _post(base + "/tts", {
            "text": "hello there", "voice": voice, "stabilize": False})
        assert status == 200 and ctype == "audio/wav"
        bodies.append(body)
    assert bodies[0] == bodies[1]
    engine._rng = np.random.default_rng(4)
    want = engine.generate("hello there", {"style": svc.styles["alice"],
                                           "speed": 1.0}, stabilize=False)
    assert bodies[0] == wav_bytes(want, engine.sr)
    sr, pcm = _parse_wav(bodies[0])
    assert sr == engine.sr and len(pcm) > 8000
    assert np.abs(pcm[:4000]).max() == 0 and np.abs(pcm[-4000:]).max() == 0


def test_tts_voice_errors(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/tts", {"text": "hi", "voice": "nobody"})
    assert e.value.code == 400
    assert "unknown voice" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/tts", {"text": "hi"})  # ambiguous: three voices
    assert e.value.code == 400


def test_tts_batch_equals_generate_batch(server):
    base, svc = server
    texts = ["first text here", "the second one"]
    status, body, _ = _post(base + "/tts_batch", {
        "texts": texts, "voice": "bob", "stabilize": False})
    assert status == 200
    wavs = json.loads(body)["wavs"]
    want = svc.engine.generate_batch(
        texts, {"style": svc.styles["bob"], "speed": 1.0}, stabilize=False)
    assert len(wavs) == 2
    for b64, w in zip(wavs, want):
        assert base64.b64decode(b64) == wav_bytes(w, svc.engine.sr)


def test_bad_request_shapes_are_400(server):
    base, _ = server
    req = urllib.request.Request(
        base + "/tts", data=b"[1, 2]",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/tts", {"voice": "alice"})
    assert e.value.code == 400
    assert "required" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/tts", {"text": "hi", "voice": "alice",
                              "speed": "fast"})
    assert e.value.code == 400


# ---------------------------------------------------------------------
# background capture
# ---------------------------------------------------------------------

def test_fused_async_serves_then_hits(engine):
    """fused_compile='async': a cold (token, frame) pair is answered on the
    two-phase path (identical audio) while the background thread makes
    the pair ready (on the CPU: one eager fused call); the next request
    on the pair runs fused, with the same audio."""
    text = "hello there you"
    engine.fixed_duration = 5  # fused and two-phase pick the same bucket
    try:
        engine.fused_compile = "async"
        engine._fused_ready = set()
        engine.fused_enabled = False
        want = engine.generate(text, {"style": np.zeros((1, 32), np.float32),
                                      "speed": 1.0}, stabilize=False)
        engine.fused_enabled = True
        calls = engine.phase2_calls
        a = engine.generate(text, {"style": np.zeros((1, 32), np.float32),
                                   "speed": 1.0}, stabilize=False)
        np.testing.assert_array_equal(a, want)  # the two-phase path
        engine.wait_fused_compiles()
        assert engine._fused_ready and not engine._fused_pending
        # the request's two-phase call and the worker's eager fused call
        assert engine.phase2_calls == calls + 2
        b = engine.generate(text, {"style": np.zeros((1, 32), np.float32),
                                   "speed": 1.0}, stabilize=False)
        np.testing.assert_array_equal(b, want)  # now fused
        assert engine.phase2_calls == calls + 3
    finally:
        engine.fused_compile = "sync"
        engine.fixed_duration = FIXED


def test_failed_background_capture_is_raised(engine, monkeypatch):
    """A failure on the background thread does not fail the request (it is
    answered two-phase) and is not swallowed: wait_fused_compiles raises
    it, and the pair stays on the two-phase path."""
    def broken(*a, **k):
        raise RuntimeError("capture broke")

    style = {"style": np.zeros((1, 32), np.float32), "speed": 1.0}
    try:
        engine.fused_compile = "async"
        engine._fused_ready = set()
        monkeypatch.setattr(engine, "_fused", broken)
        wav = engine.generate("hello there you", style, stabilize=False)
        assert wav.size > 8000
        with pytest.raises(RuntimeError, match="capture broke"):
            engine.wait_fused_compiles()
        assert engine._fused_failed and not engine._fused_ready
        engine.wait_fused_compiles()  # raised once
        engine.generate("hello there you", style, stabilize=False)
        engine.wait_fused_compiles()  # not queued again
    finally:
        engine.fused_compile = "sync"
        engine._fused_failed = set()
