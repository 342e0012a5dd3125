#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (styletts2_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py [--json PATH] [--b1-only] [--package-from DIR]

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit; torch and CUDA versions);
  2. the nvcc build of both kernels from csrc/, in parallel, timed;
  3. kernel B1 (fused AdaIN+Snake+dilated conv) against its plain PyTorch
     version at every (C, k, d) of the default config at frame bucket 256,
     f32 and bf16, with the residual/stats epilogues, a ragged T, batches
     and the bf16 kernel's other tile branches; the count of tensor-core
     instructions in the built library's SASS; then every launch of one
     bf16 phase-2 call at that bucket, timed: the kernel in eager calls
     (CUDA events around wrapper calls, host time included: the `ms` of
     the kernels line), on the device by CUDA-graph replay with warm and
     with cold L2, the plain version, the bound, and a cuDNN bf16 conv1d
     of the same shape on an already-transformed input as a yardstick for
     the conv part alone;
  4. kernel B2 (fused log-mel) against its plain version at the style shape
     (B = 1 and 6) and the three MRSTFT resolutions, timed in eager calls
     and on the device;
  5. the engine at full width (configs/config_example.yaml, bf16 decoder,
     seeded random weights): compute_style on a seeded 5-s clip, generate
     on three texts, with the launch counts of both kernels;
  6. the f32 engine on CUDA against the same engine on the CPU;
  7. the kernels line (JSON), the card line, and the result line.
Any failed check exits non-zero without the result line. Without a CUDA
device, or without the repository around it, it exits non-zero at once.
`--b1-only` stops after phase 3; with `--package-from DIR` the package
(kernels, wrappers, config) comes from the checkout in DIR, so two commits'
B1 kernels are timed by the same code in one run.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its operations over the peak for their type and its bytes over
# the memory rate
PEAK_F32 = 67e12      # f32 FMA on the CUDA cores
PEAK_BF16 = 989e12    # bf16 tensor cores
HBM_BYTES_S = 3.35e12
L2_BYTES = 50 * 2 ** 20
# kernel vs plain version on the card, as a share of max(1, max|plain|):
# f32 differs only in summation order; bf16 may flip one rounding of an
# output, i.e. one bf16 step (2^-8 relative)
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
STATS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
TEXTS = {
    "short": "Hello there, how are you today?",
    "medium": ("The quick brown fox jumps over the lazy dog while the "
               "children watch from the window and laugh at the clever "
               "animal."),
    "multi": ("It was a bright cold day in April. The clocks were striking "
              "thirteen. Winston slipped quickly through the glass doors "
              "of the building. A gritty wind swirled the dust into the "
              "hall."),
}
F32_CPU_BOUND = 5e-3  # rel-l2, CUDA vs CPU engine, f32


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fns, reps: int, replays: int = 5) -> float:
    """Device time of one call: `reps` calls, cycling through `fns` (one
    callable or a list), captured in one CUDA graph and replayed, so host
    time between launches is not in the number (the eager wrappers take
    tens of microseconds of host time per call, more than the small kernels
    take on the card). One callable reuses its inputs, which then stay in
    L2; a list whose inputs together exceed L2 reads them from HBM."""
    import torch

    fns = [fns] if callable(fns) else list(fns)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for i in range(reps):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(flops: float, nbytes: float, peak: float):
    t_ops, t_mem = flops / peak, nbytes / HBM_BYTES_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


class Checks:
    def __init__(self):
        self.failed = []

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failed.append(what)
            print(f"  FAILED: {what}", flush=True)


def b1_operands(c, t, k, dtype, gen, b=1, residual=False):
    import torch

    def rnd(*shape, sc=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * sc

    ops = dict(x=rnd(b, t, c).to(dtype), scale=rnd(b, c, sc=0.5) + 1.0,
               shift=rnd(b, c, sc=0.1), alpha=rnd(c).abs() + 0.5,
               w=rnd(k, c, c, sc=0.05).to(dtype), bias=rnd(c, sc=0.01),
               n_valid=torch.tensor([t - 37 - 101 * i for i in range(b)],
                                    dtype=torch.int32, device="cuda"))
    ops["residual"] = rnd(b, t, c).to(dtype) if residual else None
    return ops


def b1_call(fn, o, d, stats):
    return fn(o["x"], o["scale"], o["shift"], o["alpha"], o["w"], o["bias"],
              d, o["n_valid"], residual=o["residual"], out_stats=stats)


def b1_bound(b, t, c, k, itemsize, residual, peak):
    flops = 2.0 * b * t * c * c * k
    nbytes = b * t * c * itemsize * (2 + int(residual)) + k * c * c * itemsize
    return bound_ms(flops, nbytes, peak)


def tensor_core_sass(lib_path):
    """Counts of HGMMA (wgmma) and HMMA (mma.sync) instructions in the
    library's SASS, or why they could not be counted."""
    from styletts2_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump")
    if tool is None:
        cand = Path(_build.nvcc_path()).parent / "cuobjdump"
        tool = str(cand) if cand.is_file() else None
    if tool is None:
        return None, "cuobjdump not found: tensor-core instructions not counted"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120).stdout
    n = {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}
    return n, (f"HGMMA {n['HGMMA']}, HMMA {n['HMMA']} in "
               f"{Path(lib_path).name} (cuobjdump -sass)")


def phase_b1(chk: Checks, cfg, frame_bucket: int):
    """Checks at every (C, k, d) of the config; then times every launch of
    one bf16 phase-2 call at `frame_bucket`."""
    import torch
    from styletts2_tpu_torch.ops import vocoder_kernel as VK

    dec = cfg.model_params.decoder
    gen = torch.Generator(device="cuda").manual_seed(1)
    rates, n_up = dec.upsample_rates, len(dec.upsample_rates)
    stages = []
    for i in range(n_up):
        c = dec.upsample_initial_channel // 2 ** (i + 1)
        t = 2 * frame_bucket * int(np.prod(rates[: i + 1]))
        blocks = [(7 if i + 1 < n_up else 11, (1, 3, 5))]  # noise_res
        blocks += [(k, tuple(ds)) for k, ds in
                   zip(dec.resblock_kernel_sizes, dec.resblock_dilation_sizes)]
        stages.append((c, t, blocks))

    max_err = 0.0
    n_checks = 0

    def compare(c, t, k, d, dtype, residual, stats, tag="", b=1):
        nonlocal max_err, n_checks
        o = b1_operands(c, t, k, dtype, gen, b=b, residual=residual)
        got = b1_call(VK.ada_snake_conv, o, d, stats)
        want = b1_call(VK.ada_snake_conv_plain, o, d, stats)
        torch.cuda.synchronize()
        (go, gs), (wo, ws) = (got, want) if stats else ((got, None),
                                                        (want, None))
        err = (go.float() - wo.float()).abs().max().item()
        scale = max(1.0, wo.float().abs().max().item())
        name = str(dtype).split(".")[-1]
        ok = err <= TOL[name] * scale
        if stats:
            serr = (gs - ws).abs().max().item() / max(1.0, ws.abs().max().item())
            ok = ok and serr <= STATS_TOL[name]
        max_err = max(max_err, err)
        n_checks += 1
        chk.check(ok, f"B1 C={c} T={t} k={k} d={d} {name} res={residual} "
                      f"stats={stats}{tag}: err {err:.3g} vs max {scale:.3g}")
        return err, scale

    t0 = time.perf_counter()
    for c, t, blocks in stages:
        ks = sorted({k for k, _ in blocks})
        ds = sorted({d for _, dl in blocks for d in dl})
        worst = {"float32": 0.0, "bfloat16": 0.0}
        for k in ks:
            for d in ds:
                e, s = compare(c, t, k, d, torch.float32, False, False)
                worst["float32"] = max(worst["float32"], e / s)
                e, s = compare(c, t, k, d, torch.bfloat16, True, True)
                worst["bfloat16"] = max(worst["bfloat16"], e / s)
        print(f"[3 B1] C={c} T={t} k={ks} d={ds}: f32 plain epilogue "
              f"rel err {worst['float32']:.3g} (tol {TOL['float32']:g}), "
              f"bf16 residual+stats rel err {worst['bfloat16']:.3g} "
              f"(tol {TOL['bfloat16']:g})", flush=True)
    # the other epilogue combinations, a T that is no multiple of the
    # block's rows, and batches whose rows have different valid lengths;
    # the last three take the bf16 streaming kernel's other branches: 32
    # output channels per block over three unswizzled input chunks (C =
    # 96), 64 over three swizzled chunks (C = 192), and C = 64 with weights
    # too large to stay resident (k = 17, d = 9)
    for c, t, k, d, dtype, res, st, b in [
            (256, 5157, 11, 5, torch.float32, True, True, 1),
            (32, 153637, 11, 5, torch.bfloat16, False, False, 1),
            (64, 76800, 7, 3, torch.bfloat16, False, True, 1),
            (128, 25600, 3, 1, torch.bfloat16, True, False, 1),
            (32, 153600, 3, 1, torch.float32, True, True, 1),
            (256, 5157, 7, 3, torch.bfloat16, True, True, 2),
            (32, 4099, 11, 5, torch.bfloat16, True, True, 3),
            (96, 4099, 7, 3, torch.bfloat16, True, True, 1),
            (192, 5157, 11, 5, torch.bfloat16, True, True, 2),
            (64, 4099, 17, 9, torch.bfloat16, True, True, 1)]:
        compare(c, t, k, d, dtype, res, st, tag=f" (variant, B={b})", b=b)
    print(f"[3 B1] {n_checks} checks in {time.perf_counter() - t0:.1f} s, "
          f"max abs err {max_err:.4g}", flush=True)
    from styletts2_tpu_torch.ops import _build

    counts, line = tensor_core_sass(_build.library_path("vocoder"))
    print(f"[3 B1 sass] {line}", flush=True)
    if counts is not None:
        chk.check(counts["HGMMA"] + counts["HMMA"] > 0,
                  "B1 library has tensor-core instructions")

    # every launch of one bf16 phase-2 call at this bucket: per dilation,
    # conv1 (stats) and conv2 (residual + stats, no stats after the last)
    launches = {}
    for c, t, blocks in stages:
        for k, dl in blocks:
            for j, d in enumerate(dl):
                last = j == len(dl) - 1
                for key in ((c, t, k, d, False, True),
                            (c, t, k, 1, True, not last)):
                    launches[key] = launches.get(key, 0) + 1
    # ms: CUDA events around 10 eager wrapper calls (the definition of
    # earlier PRs; it includes the host's time to issue each call); device
    # ms: CUDA-graph replay of the same inputs (warm L2); cold ms: replay
    # cycling through input sets that together exceed twice the L2, so
    # inputs come from HBM as the bound assumes; plain ms: eager
    keys = ("ms", "device_ms", "cold_ms", "plain_ms", "bound_ms", "conv_ms")
    totals = dict.fromkeys(keys + ("ops_ms",), 0.0)
    totals["n"] = 0
    per_stage, detail = {}, []
    for (c, t, k, d, res, st), n in sorted(launches.items()):
        o = b1_operands(c, t, k, torch.bfloat16, gen, residual=res)
        ems = cuda_ms(lambda: b1_call(VK.ada_snake_conv, o, d, st), 10)
        dms = graph_ms(lambda: b1_call(VK.ada_snake_conv, o, d, st), 10)
        in_bytes = (t * c * (1 + int(res)) + k * c * c) * 2
        n_sets = -(-2 * L2_BYTES // in_bytes)
        sets = [b1_operands(c, t, k, torch.bfloat16, gen, residual=res)
                for _ in range(n_sets)]
        cold = graph_ms([lambda s=s: b1_call(VK.ada_snake_conv, s, d, st)
                         for s in sets], n_sets * -(-10 // n_sets))
        del sets
        pms = cuda_ms(lambda: b1_call(VK.ada_snake_conv_plain, o, d, st), 3)
        # yardstick: cuDNN's bf16 conv of the same (C, T, k, d) on an
        # already-transformed (B, C, T) input; no affine, snake or stats
        # (device time, warm L2)
        zc = o["x"].transpose(1, 2).contiguous()
        wc = o["w"].permute(2, 1, 0).contiguous()
        bc = o["bias"].to(torch.bfloat16)
        cms = graph_ms(lambda: torch.nn.functional.conv1d(
            zc, wc, bc, padding=d * (k - 1) // 2, dilation=d), 10)
        bms, by = b1_bound(1, t, c, k, 2, res, PEAK_BF16)
        row = dict(ms=ems, device_ms=dms, cold_ms=cold, plain_ms=pms,
                   bound_ms=bms, conv_ms=cms)
        detail.append(dict(c=c, t=t, k=k, d=d, residual=res, stats=st,
                           launches=n, **row))
        for key in keys:
            totals[key] += n * row[key]
        totals["ops_ms"] += n * (bms if by == "operations" else 0.0)
        totals["n"] += n
        ps = per_stage.setdefault((c, t), dict.fromkeys(keys + ("n",), 0.0))
        ps["n"] += n
        for key in keys:
            ps[key] += n * row[key]
    def times(v):
        return (f"kernel {v['ms']:.3f} ms in eager calls, {v['device_ms']:.3f}"
                f" ms on the device (warm L2), {v['cold_ms']:.3f} ms (cold "
                f"L2); plain {v['plain_ms']:.3f} ms, bound "
                f"{v['bound_ms']:.4f} ms, cuDNN conv part alone "
                f"{v['conv_ms']:.3f} ms on the device")

    for (c, t), ps in per_stage.items():
        print(f"[3 B1 time] bf16 C={c} T={t}: {int(ps['n'])} launches, "
              f"{times(ps)}", flush=True)
    by = "operations" if totals["ops_ms"] >= totals["bound_ms"] / 2 else "bytes"
    print(f"[3 B1 time] one bf16 phase-2 call at frame bucket {frame_bucket}"
          f": {totals['n']} launches, {times(totals)} ({by})", flush=True)
    return dict(max_abs_err=max_err, bound_by=by, detail=detail,
                **{key: totals[key] for key in keys})


def phase_b2(chk: Checks):
    import torch
    from styletts2_tpu_torch.ops import mel_kernel as MK

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [("style B=1", 1, 72000, 2048, 300, 1200, 80),
             ("style B=6", 6, 72000, 2048, 300, 1200, 80),
             ("mrstft 1024", 1, 72000, 1024, 120, 600, 128),
             ("mrstft 2048", 1, 72000, 2048, 240, 1200, 128),
             ("mrstft 512", 1, 72000, 512, 50, 240, 128)]
    out = {}
    max_err = 0.0
    for name, b, t, n_fft, hop, win, m in cases:
        wave = torch.randn(b, t, generator=gen, device="cuda") * 0.3
        kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, n_mels=m)
        got = MK.log_mel(wave, **kw)
        want = MK.log_mel_plain(wave, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, atol=2e-5, rtol=1e-4))
        max_err = max(max_err, err)
        chk.check(ok, f"B2 {name}: err {err:.3g}")
        # ms: eager calls (as in earlier PRs); device ms: graph replay
        ems = cuda_ms(lambda: MK.log_mel(wave, **kw), 10)
        dms = graph_ms(lambda: MK.log_mel(wave, **kw), 10)
        pms = cuda_ms(lambda: MK.log_mel_plain(wave, **kw), 5)
        n = b * got.shape[2]
        f = n_fft // 2 + 1
        bms, by = bound_ms(4.0 * n * n_fft * f + 2.0 * n * f * m,
                           n * n_fft * 4 + 2 * n_fft * f * 4 + n * m * 4,
                           PEAK_F32)
        out[name] = dict(ms=ems, device_ms=dms, plain_ms=pms, bound_ms=bms,
                         bound_by=by)
        print(f"[4 B2] {name} ({b}x{t}, n_fft {n_fft}, {m} mels, {n} "
              f"frames): max abs err {err:.3g} (atol 2e-5 + rtol 1e-4), "
              f"kernel {ems:.3f} ms in eager calls, {dms:.3f} ms on the "
              f"device; plain {pms:.3f} ms, bound {bms:.4f} ms ({by})",
              flush=True)
    return dict(max_abs_err=max_err, shapes=out, **out["style B=1"])


def phase_engine(chk: Checks, cfg, card: str):
    import torch
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.ops import mel_kernel as MK
    from styletts2_tpu_torch.ops import vocoder_kernel as VK

    t0 = time.perf_counter()
    engine = StyleTTS2(cfg, seed=0)  # CUDA, bf16 decoder from the config
    print(f"[5 engine] init {time.perf_counter() - t0:.1f} s, decoder "
          f"{engine.dtype}, {sum(p.numel() for p in engine.modules.parameters())}"
          f" parameters", flush=True)
    rng = np.random.default_rng(0)
    sr = engine.sr
    tt = np.arange(sr * 5) / sr
    clip = (0.3 * np.sin(2 * np.pi * 180 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
            + 0.05 * rng.standard_normal(len(tt))).astype(np.float32)
    # warm-up (cuDNN plans, first launches) before the counted run
    engine.generate(TEXTS["short"], {"style": engine.compute_style(clip)})
    torch.cuda.synchronize()

    VK.ada_snake_conv.launches = 0
    MK.log_mel.launches = 0
    engine.phase2_calls = 0
    t0 = time.perf_counter()
    ref_s = engine.compute_style(clip)
    torch.cuda.synchronize()
    print(f"[5 engine] compute_style 5-s clip: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, style "
          f"{tuple(ref_s.shape)} finite "
          f"{bool(torch.isfinite(ref_s).all())} | {card}", flush=True)
    chk.check(bool(torch.isfinite(ref_s).all()), "style finite")
    style = {"style": ref_s, "speed": 1.0}
    for name, text in TEXTS.items():
        calls0 = engine.phase2_calls
        t0 = time.perf_counter()
        wav = engine.generate(text, style)
        wall = time.perf_counter() - t0
        secs = len(wav) / sr
        finite = bool(np.isfinite(wav).all())
        edges = (np.abs(wav[:4000]).max() == 0 and np.abs(wav[-4000:]).max() == 0)
        audible = float(np.abs(wav[4000:-4000]).max()) if len(wav) > 8000 else 0.0
        chk.check(finite and edges and len(wav) > 8000 and audible > 0
                  and np.abs(wav).max() <= 1.0, f"generate {name}")
        print(f"[5 engine] generate {name}: {len(wav)} samples "
              f"({secs:.2f} s audio), finite {finite}, peak {audible:.3f}, "
              f"{engine.phase2_calls - calls0} phase-2 calls, wall "
              f"{wall * 1e3:.1f} ms, 1/RTF {secs / wall:.1f} | {card}",
              flush=True)
    b1, b2, p2 = (VK.ada_snake_conv.launches, MK.log_mel.launches,
                  engine.phase2_calls)
    print(f"[5 engine] launches: B1 {b1} (= 96 x {p2} phase-2 calls: "
          f"{b1 == 96 * p2}), B2 {b2}", flush=True)
    chk.check(b1 == 96 * p2 and p2 > 0, "B1 launches == 96 x phase-2 calls")
    chk.check(b2 >= 1, "B2 launched on the main path")
    return b1, b2


def phase_f32_vs_cpu(chk: Checks, cfg):
    import copy

    import torch
    from styletts2_tpu_torch.infer import StyleTTS2

    text = "Hello there"
    out = {}
    for dev in ("cuda", "cpu"):
        engine = StyleTTS2(copy.deepcopy(cfg), seed=3, decoder_dtype="float32",
                           device=dev)
        n_tok = len(engine.cleaner(text)) + 2
        engine.fixed_duration = cfg.tpu.frame_buckets[0] // n_tok
        s = np.random.default_rng(3).standard_normal((1, 128)).astype(
            np.float32) * 0.3
        t0 = time.perf_counter()
        out[dev] = engine.generate(text, {"style": s}, stabilize=False)
        print(f"[6 f32] {dev}: {len(out[dev])} samples in "
              f"{time.perf_counter() - t0:.1f} s ({n_tok} tokens x "
              f"{engine.fixed_duration} frames)", flush=True)
    a, b = out["cuda"], out["cpu"]
    rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))
    ok = a.shape == b.shape and rel < F32_CPU_BOUND and np.abs(b).max() > 0
    chk.check(ok, f"f32 CUDA vs CPU rel-l2 {rel:.3g}")
    print(f"[6 f32] CUDA vs CPU engine, frame bucket "
          f"{cfg.tpu.frame_buckets[0]}: rel-l2 {rel:.3g} (bound "
          f"{F32_CPU_BOUND:g})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the measurements here")
    ap.add_argument("--b1-only", action="store_true",
                    help="run phases 1-3 only and print no result line")
    ap.add_argument("--package-from", metavar="DIR",
                    help="import styletts2_tpu_torch from the checkout in "
                    "DIR instead of this one (with --b1-only: time another "
                    "commit's kernel with this script's timers)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.package_from).resolve() if args.package_from else ROOT
    if not (root / "styletts2_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: run from a checkout of the repository (no "
              f"styletts2_tpu_torch in {root})", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)
    chk = Checks()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = card[0] if card else "unknown card"
    print(f"[1 card] {card} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    took = _build.build()
    print(f"[2 build] nvcc {', '.join(f'{k} {v:.1f} s' for k, v in took.items()) or 'up to date'}"
          f"; total {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = load_config(str(root / "configs" / "config_example.yaml"))
    b1 = phase_b1(chk, cfg, frame_bucket=256)
    if args.b1_only:
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "package": str(root), "b1": b1,
                 "failed": chk.failed}, indent=1))
        return 1 if chk.failed else 0
    b2 = phase_b2(chk)
    n_b1, n_b2 = phase_engine(chk, cfg, card)
    phase_f32_vs_cpu(chk, cfg)

    kernels = [
        dict(name="fused_ada_snake_conv", route="cuda",
             source="styletts2_tpu_torch/csrc/vocoder.cu",
             replaces="styletts2_tpu/ops/vocoder_pallas.py:226",
             launches=n_b1, max_abs_err=b1["max_abs_err"], ms=b1["ms"],
             plain_ms=b1["plain_ms"], bound_ms=b1["bound_ms"],
             bound_by=b1["bound_by"], library_ms=None,
             device_ms=b1["device_ms"], device_cold_l2_ms=b1["cold_ms"]),
        dict(name="fused_log_mel", route="cuda",
             source="styletts2_tpu_torch/csrc/mel.cu",
             replaces="styletts2_tpu/ops/mel_pallas.py:82",
             launches=n_b2, max_abs_err=b2["max_abs_err"], ms=b2["ms"],
             plain_ms=b2["plain_ms"], bound_ms=b2["bound_ms"],
             bound_by=b2["bound_by"], library_ms=None,
             device_ms=b2["device_ms"]),
    ]
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "kernels": kernels, "b1": b1, "b2": b2,
             "failed": chk.failed}, indent=1))
    if chk.failed:
        print(f"chip_smoke: {len(chk.failed)} checks failed: {chk.failed}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
