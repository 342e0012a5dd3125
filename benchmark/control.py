"""The control of the correctness check: the reference put in the
program's place at the nearest precisions below the configuration's
(TF32 for its float32 parts, float8 e4m3 operands for its bf16 decoder),
judged by the same comparison as the program, on the cell's own traffic.

    python3 benchmark/control.py --workload <name> --seeds 11 12 13

Prints, per seed, the numbers a run compares (style_gap, pcm_rms_err,
length_mismatch) for the control, beside the cell's limits: each has to
fail at least one. With --durations it also prints the largest gap
between the program's and the reference's float durations (the
engine's phase 1 on the same chunks), which the rounding tolerance
synth.TAU has to exceed. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, device, durations: bool = False) -> dict:
    from benchmark.harness import cells as C
    from benchmark.reference import params as P
    from benchmark.reference import synth as S
    from benchmark.reference.model import Reference

    run = C.Run(cell, seed, device, 0.0)
    mix = cell.mix
    sp = P.spec(run.mp, len(run.symbols) + 1)
    weights = P.make_weights(sp, C.sub_seed(seed, "weights"), device)
    ref = Reference(run.cfg, weights, device)
    ctl = Reference(run.cfg, weights, device, precision="control")
    clip = C.voice_clip(C.sub_seed(seed, "voice"), run.sr)
    s_ref, s_ctl = ref.style(clip), ctl.style(clip)
    scale = run.duration_scale(ref, s_ref)
    texts = run.texts("window")
    sample = [texts.text() for _ in range(mix["sample"] * 4)]
    sample = sorted(sample, key=len)[-mix["sample"]:]   # the longest
    t = 0.2 if mix["stabilize"] else 0.0
    base = S.base_seeds(C.sub_seed(seed, "engine"), 1)[0]
    errs, gaps, mismatch = [], [], 0
    for i, text in enumerate(sample):
        chain = i % mix.get("batch", 1)
        want = S.plan_text(ref, text, s_ref, scale, base, chain,
                           mix["n_merge"], t=t, speed=mix["speed"])
        got = S.plan_text(ctl, text, s_ctl, scale, base, chain,
                          mix["n_merge"], t=t, speed=mix["speed"])
        mids = []
        for c in got:
            pcm = ctl.phase2(c.t_en, c.d, s_ctl, c.pred)
            mids.append(pcm.astype(np.float32)[S.EDGE: len(pcm) - S.EDGE]
                        / 32767.0)
        z = np.zeros(S.EDGE, np.float32)
        wav = np.concatenate([z] + mids + [z])
        v = S.compare(ref, want, s_ref, wav)
        gaps.append(v.gap)
        errs.append(v.err_rms)
        mismatch += int(not v.length_ok)
    out = {"seed": seed,
           "style_gap": float(torch.linalg.vector_norm(s_ctl - s_ref)
                              / torch.linalg.vector_norm(s_ref)),
           "pcm_rms_err": float(max(errs)), "length_mismatch": mismatch,
           "pcm_rms_errs": [float(e) for e in errs],
           "pcm_gaps": [float(g) for g in gaps]}
    if durations:
        out["duration_gap"] = scale * _duration_gap(run, ref, weights,
                                                    s_ref, sample, device)
    return out


def _duration_gap(run, ref, weights, s_ref, sample, device) -> float:
    """Largest |program - reference| of the duration head's expected
    durations (before the scale) over the sample's chunks: the engine's
    own phase 1, batch 1, on the reference's style."""
    import copy

    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.infer import StyleTTS2

    from benchmark.reference import frontend as FE
    from benchmark.reference import params as P

    eng = StyleTTS2(load_config(copy.deepcopy(run.cfg)),
                    params=P.host_tree(weights), device=device)
    worst = 0.0
    for text in sample:
        for c in run.chunks(text):
            toks = FE.tokens(c, run.symbols)
            x = torch.tensor([toks], device=device)
            m = torch.ones_like(x, dtype=torch.bool)
            got = eng._phase1(x, m, s_ref[None])[2][0].cpu().numpy()
            want = ref.phase1(toks, s_ref)[2]
            worst = max(worst, float(np.abs(got - want).max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--durations", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cells as C

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    cell = C.load(ROOT, args.workload)
    for seed in args.seeds:
        r = readings(cell, seed, "cuda", args.durations)
        r["limits"] = cell.limits
        r["fails"] = [k for k in cell.limits if r[k] > cell.limits[k]]
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
