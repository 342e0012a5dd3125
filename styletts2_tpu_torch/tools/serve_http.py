"""Dependency-free HTTP TTS server (stdlib http.server) over the port's
engine. Counterpart of styletts2_tpu/tools/serve_http.py: the same routes,
JSON fields and status codes.

Endpoints:
  GET  /health            -> {"ok": true, "decoder": ..., "sr": ...,
                              "n_voices": ...}
  GET  /voices            -> {"voices": ["name", ...]}
  POST /tts               -> audio/wav bytes
        JSON body: {"text": str, "voice": str (optional when one voice),
                    "speed": 1.0, "stabilize": true, "n_merge": 16}
  POST /tts_batch         -> {"wavs": [base64 WAV, ...]}
        JSON body: {"texts": [str, ...], "voice": ..., same knobs}
A malformed body, a missing field or an unknown voice is a 400, a
synthesis failure a 500 (JSON {"error": ...} both).

Voices come from a voicepack (tools/export_serving.save_voicepack) and/or
a directory of reference clips (WAV or FLAC) whose styles are computed at
start-up. Synthesis is serialised with a lock (the engine carries RNG
state); concurrent requests queue. The engine runs with
`fused_compile = "async"`: a request on a (token, frame) pair with no
CUDA graph yet is answered on the two-phase path while the pair's graph is
captured on a background thread, so no request waits for a capture.

Usage (on the GPU):
  python -m styletts2_tpu_torch.tools.serve_http --config ... --ckpt ... \
      [--voicepack pack.npz] [--voices-dir dir/] [--port 8080] [--warmup]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import threading
import wave as _wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

import numpy as np


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """16-bit PCM mono WAV in memory (audio.write_wav, minus the file)."""
    pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
           * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with _wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())
    return buf.getvalue()


class TTSService:
    """Engine + named styles + the serialisation lock."""

    def __init__(self, engine, styles: Dict[str, Any]):
        if not styles:
            raise ValueError("no voices: pass a voicepack, a voices dir, "
                             "or a styles dict")
        self.engine = engine
        self.styles = styles
        self.lock = threading.Lock()

    @classmethod
    def build(cls, engine, voicepack: Optional[str] = None,
              voices_dir: Optional[str] = None,
              denoise: float = 0.3) -> "TTSService":
        from styletts2_tpu_torch.tools.export_serving import (load_voicepack,
                                                              voice_files)

        styles: Dict[str, Any] = {}
        if voicepack:
            _, packed = load_voicepack(voicepack)
            styles.update(packed)
        if voices_dir:
            for name, path in voice_files(voices_dir).items():
                styles[name] = engine.compute_style(
                    path, denoise=denoise).detach().cpu().numpy()
        return cls(engine, styles)

    def _style(self, req: Dict[str, Any]) -> Dict[str, Any]:
        voice = req.get("voice")
        if voice is None:
            if len(self.styles) != 1:
                raise KeyError("'voice' is required when several voices "
                               f"are loaded: {sorted(self.styles)}")
            voice = next(iter(self.styles))
        if voice not in self.styles:
            raise KeyError(f"unknown voice {voice!r}; "
                           f"have {sorted(self.styles)}")
        return {"style": self.styles[voice],
                "speed": float(req.get("speed", 1.0))}

    def tts(self, req: Dict[str, Any]) -> bytes:
        if "text" not in req:
            raise KeyError("'text' is required")
        text = req["text"]
        style = self._style(req)
        with self.lock:
            wav = self.engine.generate(
                text, style, stabilize=bool(req.get("stabilize", True)),
                n_merge=int(req.get("n_merge", 16)))
        return wav_bytes(wav, self.engine.sr)

    def tts_batch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if "texts" not in req:
            raise KeyError("'texts' is required")
        texts = list(req["texts"])
        style = self._style(req)
        with self.lock:
            wavs = self.engine.generate_batch(
                texts, style, stabilize=bool(req.get("stabilize", True)),
                n_merge=int(req.get("n_merge", 16)))
        return {"wavs": [base64.b64encode(
            wav_bytes(w, self.engine.sr)).decode("ascii") for w in wavs]}


class _Handler(BaseHTTPRequestHandler):
    service: TTSService  # set by make_server

    def log_message(self, fmt, *args):  # quiet by default
        if os.environ.get("STYLETTS2_TPU_HTTP_LOG") == "1":
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: Any) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        svc = self.service
        if self.path == "/health":
            eng = svc.engine
            self._send_json(200, {
                "ok": True, "sr": eng.sr,
                "decoder": eng.cfg.model_params.decoder.type,
                "n_voices": len(svc.styles)})
        elif self.path == "/voices":
            self._send_json(200, {"voices": sorted(svc.styles)})
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
        except ValueError as e:  # json.JSONDecodeError is a ValueError
            self._send_json(400, {"error": f"invalid JSON body: {e}"})
            return
        try:
            if self.path == "/tts":
                self._send(200, self.service.tts(req), "audio/wav")
            elif self.path == "/tts_batch":
                self._send_json(200, self.service.tts_batch(req))
            else:
                self._send_json(404, {"error": f"no route {self.path}"})
        except KeyError as e:
            # a malformed request or an unknown voice: the client's error.
            # e.args[0] is the message (str(e) would add repr quotes)
            self._send_json(400, {"error": str(e.args[0]) if e.args
                                  else str(e)})
        except (TypeError, ValueError) as e:
            self._send_json(400, {"error": f"bad request: {e}"})
        except Exception as e:  # synthesis failures as 500 JSON
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(service: TTSService, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    handler = type("Handler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None) -> None:
    from styletts2_tpu_torch.infer import StyleTTS2

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="native checkpoint or reference .pth")
    ap.add_argument("--voicepack", default=None)
    ap.add_argument("--voices-dir", default=None)
    ap.add_argument("--denoise", type=float, default=0.3)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--warmup", action="store_true",
                    help="capture the bucketed graphs before serving")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = StyleTTS2(args.config, args.ckpt, device=args.device)
    engine.fused_compile = "async"
    service = TTSService.build(engine, voicepack=args.voicepack,
                               voices_dir=args.voices_dir,
                               denoise=args.denoise)
    if args.warmup:
        engine.warmup()
    srv = make_server(service, args.host, args.port)
    print(f"serving {sorted(service.styles)} on "
          f"http://{args.host}:{srv.server_address[1]}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
