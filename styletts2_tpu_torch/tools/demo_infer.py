"""Text -> WAV with a reference voice, from the command line (reference
Demo/infer.py). Counterpart of styletts2_tpu/tools/demo_infer.py, with
the same flags plus --device. Phonemizes with espeak-ng through the
`phonemizer` package when it is installed; otherwise the raw text goes to
the character-level cleaner (its letters are in the symbol table, so it
still synthesises, with poorer pronunciation).

Usage:
  python -m styletts2_tpu_torch.tools.demo_infer \
      --config configs/config_example.yaml --ckpt model.pth \
      --ref-wav speaker.wav --text "Hello world." --out audio.wav
"""

from __future__ import annotations

import argparse


def phonemize(text: str, lang: str = "en-us") -> str:
    try:
        from phonemizer import phonemize as _ph  # pragma: no cover

        return _ph(text, language=lang, backend="espeak",
                   preserve_punctuation=True, with_stress=True)
    except Exception:
        print("styletts2_tpu_torch: phonemizer/espeak-ng unavailable; "
              "synthesizing from raw characters")
        return text


def main(argv=None) -> None:
    from styletts2_tpu_torch import audio as AUD
    from styletts2_tpu_torch.infer import StyleTTS2

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ref-wav", required=True,
                    help="reference clip, WAV or FLAC")
    ap.add_argument("--text", required=True)
    ap.add_argument("--out", default="audio.wav")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--denoise", type=float, default=0.3)
    ap.add_argument("--no-avg-style", action="store_true")
    ap.add_argument("--no-stabilize", action="store_true")
    ap.add_argument("--lang", default="en-us")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    engine = StyleTTS2(args.config, args.ckpt, device=args.device)
    style = engine.get_styles({"path": args.ref_wav, "speed": args.speed},
                              denoise=args.denoise,
                              avg_style=not args.no_avg_style)
    phonemes = phonemize(args.text, args.lang)
    wav = engine.generate(phonemes, style,
                          stabilize=not args.no_stabilize)
    AUD.write_wav(args.out, wav, engine.sr)
    print(f"wrote {len(wav) / engine.sr:.2f}s of audio to {args.out}")


if __name__ == "__main__":
    main()
