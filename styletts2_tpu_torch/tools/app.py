"""Web demo (gradio; reference Demo/Space/app.py): a voice dropdown over a
directory of reference clips, speed, denoise strength, style averaging and
duration stabilisation, as the reference Space has (app.py:61-175).
Counterpart of styletts2_tpu/tools/app.py. gradio is imported when the app
is built, not with the module, and its absence ends the program with a
message.

Usage:
  python -m styletts2_tpu_torch.tools.app --config ... --ckpt ... \
      --voices-dir dir/
"""

from __future__ import annotations

import argparse


def build_app(engine, voices_dir: str):
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed; use styletts2_tpu_torch.tools."
            "demo_infer for the CLI demo instead") from e
    from styletts2_tpu_torch.tools.export_serving import voice_files

    voices = voice_files(voices_dir)
    if not voices:
        raise SystemExit(f"no .wav or .flac voices found in {voices_dir}")
    style_cache = {}

    def synthesize(text, voice, speed, denoise, avg_style, stabilize):
        key = (voice, round(denoise, 3), bool(avg_style))
        if key not in style_cache:
            engine.ref_s = engine.compute_style(
                voices[voice], denoise=denoise,
                split_dur=3 if avg_style else 0)
            style_cache[key] = engine.ref_s
        style = {"style": style_cache[key], "speed": speed}
        wav = engine.generate(text, style, stabilize=stabilize)
        return engine.sr, wav

    return gr.Interface(
        fn=synthesize,
        inputs=[
            gr.Textbox(label="Text"),
            gr.Dropdown(sorted(voices), label="Voice",
                        value=sorted(voices)[0]),
            gr.Slider(0.5, 1.5, value=1.0, label="Speed"),
            gr.Slider(0.0, 1.0, value=0.3, label="Denoise strength"),
            gr.Checkbox(value=True, label="Average styles over 3s windows"),
            gr.Checkbox(value=True, label="Stabilize speaking rate"),
        ],
        outputs=gr.Audio(label="Synthesized audio"),
        title="StyleTTS2-lite (PyTorch/CUDA)",
    )


def main(argv=None) -> None:  # pragma: no cover - interactive
    from styletts2_tpu_torch.infer import StyleTTS2

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--voices-dir", required=True)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = StyleTTS2(args.config, args.ckpt, device=args.device)
    engine.fused_compile = "async"
    build_app(engine, args.voices_dir).launch(server_port=args.port)


if __name__ == "__main__":
    main()
