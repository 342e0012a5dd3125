"""Serving export: the engine's bucketed phase-1 and phase-2 graphs through
torch.export, and voicepacks. Counterpart of
styletts2_tpu/tools/export_serving.py.

`export_engine` writes one phase-1 graph per token bucket and one phase-2
graph per (token, frame) bucket pair, each a `torch.export.save` file,
with a `manifest.json` of the JAX tool's layout (keys `phase1/{tb}` and
`phase2/{tb}/{fb}`). Batch 1, static shapes, on the engine's device and
in its decoder dtype. Kernel B1 is inside every phase-2 graph of a
HiFi-GAN or iSTFTNet engine as the dispatcher operator
`styletts2_tpu_torch::ada_snake_conv` (ops/vocoder_kernel.py), so a graph
loaded on the GPU launches the kernel, and its plain version on the CPU.
`load_exported` loads the graphs in a process that imports torch and that
operator module only: no model code (`nn`, `infer`, `models`).

Voicepacks: precomputed style vectors plus the symbol table in one .npz
(reference ONNX/with_voicepacks.py), in the JAX tool's format, so each
package reads the other's packs:
  symbol_table: the symbol dict as a JSON string
  style/<name>: a (1, style_dim) float32 array per voice

Usage, the JAX tool's form (--out is the graphs directory):
  python -m styletts2_tpu_torch.tools.export_serving \
      --config configs/config_example.yaml --ckpt model.pth \
      --out export_dir --token-buckets 64,128 --frame-buckets 200,400,800
and a voicepack (--out is then the pack; --graphs-out DIR also writes
the graphs):
  python -m styletts2_tpu_torch.tools.export_serving \
      --config configs/config_example.yaml --ckpt model.pth \
      --voices-dir voices/ --out pack.npz [--graphs-out export_dir]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Callable, Dict, List, Tuple

import numpy as np


def _graph_modules(engine):
    """The two phases as modules that hold only the weights they read:
    phase 1 the text encoder and the predictor, phase 2 the predictor and
    the decoder."""
    import torch

    class Phase1(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.text_encoder = engine.modules["text_encoder"]
            self.predictor = engine.modules["predictor"]

        def forward(self, tokens, mask, s):
            return engine._phase1_impl(tokens, mask, s)

    class Phase2(torch.nn.Module):
        def __init__(self, n_frames: int):
            super().__init__()
            self.predictor = engine.modules["predictor"]
            self.decoder = engine.modules["decoder"]
            self.n_frames = n_frames

        def forward(self, t_en, d, s, durs):
            return engine._phase2_impl(t_en, d, s, durs, self.n_frames)

    return Phase1, Phase2


def _export(module, args):
    """torch.export of `module` on `args` (static shapes), with the
    weights it does not read left out of the program."""
    import warnings

    import torch

    with warnings.catch_warnings():
        # nn.LSTM re-assigns its _flat_weights list when the tracer swaps
        # its parameters; they are the parameters themselves
        warnings.filterwarnings("ignore", message=r"The tensor attributes "
                                r".*_flat_weights")
        ep = torch.export.export(module, args, strict=False)
    return _drop_unused_weights(ep)


def _drop_unused_weights(ep):
    """Remove the parameter and buffer inputs no node reads (the fused
    weight-norm conv weights of a block whose B1 route reads its
    prepacked copy, the other phase's heads), so the file carries one
    copy of each weight it uses."""
    from torch.export.graph_signature import InputKind

    graph = ep.graph_module.graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    keep_specs, dropped = [], []
    for node, spec in zip(placeholders, ep.graph_signature.input_specs):
        if (spec.kind in (InputKind.PARAMETER, InputKind.BUFFER)
                and not node.users):
            graph.erase_node(node)
            dropped.append(spec.target)
        else:
            keep_specs.append(spec)
    if not dropped:
        return ep
    ep.graph_signature.input_specs[:] = keep_specs
    for name in dropped:
        ep.state_dict.pop(name, None)
        ep.constants.pop(name, None)
    ep.graph_module.recompile()
    ep.validate()
    return ep


def export_engine(engine, out_dir: str, token_buckets: List[int],
                  frame_buckets: List[int]) -> Dict[str, str]:
    """Write `phase1_t{tb}.pt2` per token bucket and `phase2_t{tb}_f{fb}.pt2`
    per pair, and `manifest.json` ({"graphs": {key: file}, "sr", "hop",
    "style_dim"}); returns the graphs' {key: file}. Phase 1 takes (tokens
    int64 (1, tb), mask bool (1, tb), s f32 (1, style_dim)) and returns
    (t_en, d, durations); phase 2 takes (t_en, d, s, durations int32
    (1, tb)) and returns int16 PCM (1, 2 * fb * hop). The single-device
    engine only."""
    import torch

    if engine.mesh is not None or engine.seq_parallel:
        raise ValueError(
            "export_engine exports the single-device engine: build the "
            "engine without a mesh and without seq_parallel")
    os.makedirs(out_dir, exist_ok=True)
    manifest: Dict[str, str] = {}
    style_dim = engine.cfg.model_params.style_dim
    dev = engine.device
    Phase1, Phase2 = _graph_modules(engine)

    s = torch.zeros((1, style_dim), dtype=torch.float32, device=dev)
    with torch.no_grad():
        for tb in token_buckets:
            tokens = torch.zeros((1, tb), dtype=torch.int64, device=dev)
            mask = torch.ones((1, tb), dtype=torch.bool, device=dev)
            # an eager run first builds the cached DSP constants outside
            # the tracer, and gives phase 2 its example inputs
            t_en, d, _ = engine._phase1_impl(tokens, mask, s)
            ep = _export(Phase1(), (tokens, mask, s))
            name = f"phase1_t{tb}.pt2"
            torch.export.save(ep, os.path.join(out_dir, name))
            manifest[f"phase1/{tb}"] = name

            durs = torch.ones((1, tb), dtype=torch.int32, device=dev)
            for fb in frame_buckets:
                engine._phase2_impl(t_en, d, s, durs, fb)
                ep = _export(Phase2(fb), (t_en, d, s, durs))
                name2 = f"phase2_t{tb}_f{fb}.pt2"
                torch.export.save(ep, os.path.join(out_dir, name2))
                manifest[f"phase2/{tb}/{fb}"] = name2

    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({"graphs": manifest,
                   "sr": engine.sr, "hop": engine.hop,
                   "style_dim": style_dim}, f, indent=2)
    return manifest


def load_exported(out_dir: str) -> Tuple[dict, Dict[str, Callable]]:
    """-> (manifest, {key: callable}) for a directory `export_engine`
    wrote. Each callable runs its graph under inference mode on the device
    it was exported on (B1 as the registered operator: the kernel on CUDA)
    and keeps the graph module as `.module`. Turns TF32 off, as the
    engine does. Imports torch and ops/vocoder_kernel only."""
    import torch

    from styletts2_tpu_torch.ops import vocoder_kernel  # noqa: F401  the op

    # the engine's f32 numerics: cuDNN's convolutions default to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)

    def runner(module):
        def run(*args):
            with torch.inference_mode():
                return module(*args)
        run.module = module  # the loaded torch.fx GraphModule
        return run

    graphs = {key: runner(torch.export.load(os.path.join(out_dir, name))
                          .module())
              for key, name in manifest["graphs"].items()}
    return manifest, graphs


def save_voicepack(engine, out_path: str, voices: Dict[str, str],
                   denoise: float = 0.3) -> None:
    """Compute the style of each named reference clip (WAV or FLAC) and
    write them with the engine's symbol table."""
    styles = {name: engine.compute_style(path, denoise=denoise)
              .detach().cpu().numpy() for name, path in voices.items()}
    np.savez(out_path,
             symbol_table=json.dumps(engine.symbol_dict),
             **{f"style/{k}": v for k, v in styles.items()})
    print(f"voicepack with {len(styles)} voices -> {out_path}")


def load_voicepack(path: str):
    """-> (symbol table dict, {voice: style array})."""
    data = np.load(path, allow_pickle=False)
    symbol_table = json.loads(str(data["symbol_table"]))
    styles = {k.split("/", 1)[1]: data[k] for k in data.files
              if k.startswith("style/")}
    return symbol_table, styles


def voice_files(voices_dir: str) -> Dict[str, str]:
    """{file stem: path} of every .wav and .flac in a directory."""
    paths = sorted(glob.glob(os.path.join(voices_dir, "*.wav"))
                   + glob.glob(os.path.join(voices_dir, "*.flac")))
    return {os.path.splitext(os.path.basename(p))[0]: p for p in paths}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--graphs-out", default=None,
                    help="write the phase-1/phase-2 graphs here (needed "
                    "only beside --voices-dir; else --out is the graphs "
                    "directory)")
    ap.add_argument("--token-buckets", default="64,128")
    ap.add_argument("--frame-buckets", default="200,400,800")
    ap.add_argument("--voices-dir", default=None,
                    help="write a voicepack of these clips to --out")
    ap.add_argument("--denoise", type=float, default=0.3)
    ap.add_argument("--out", default=None,
                    help="the graphs directory (the JAX tool's --out), or "
                    "with --voices-dir the voicepack path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.out is None and args.graphs_out is None:
        ap.error("give --out (the graphs directory, or the voicepack "
                 "with --voices-dir), or --graphs-out")
    if args.voices_dir is not None and args.out is None:
        ap.error("--voices-dir needs --out")
    if args.voices_dir is None and None not in (args.out, args.graphs_out):
        ap.error("without --voices-dir, --out is the graphs directory: "
                 "give --out or --graphs-out, not both")
    graphs_out = args.graphs_out
    if graphs_out is None and args.voices_dir is None:
        graphs_out = args.out

    from styletts2_tpu_torch.infer import StyleTTS2

    engine = StyleTTS2(args.config, args.ckpt, device=args.device)
    if graphs_out is not None:
        tbs = [int(x) for x in args.token_buckets.split(",")]
        fbs = [int(x) for x in args.frame_buckets.split(",")]
        manifest = export_engine(engine, graphs_out, tbs, fbs)
        print(f"exported {len(manifest)} graphs to {graphs_out}")
    if args.voices_dir is not None:
        save_voicepack(engine, args.out, voice_files(args.voices_dir),
                       denoise=args.denoise)


if __name__ == "__main__":
    main()
