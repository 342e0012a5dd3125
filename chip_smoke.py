#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (styletts2_tpu_torch) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py [--json PATH] [--b1-only] [--deploy-only]
                          [--slm-only] [--parallel-only] [--onnx-only]
                          [--export-only] [--tools-only]
                          [--package-from DIR]

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
     seeded random weights), each window with the launch counts of both
     kernels (a fused-graph replay counts the launches it recorded):
     compute_style on a seeded 5-s clip and generate on three texts (the
     short one through a replayed fused CUDA graph); the short text through
     the fused graph against the two-phase path (graph replay == eager
     `_fused`, equal totals, five runs of each: median wall and 1/RTF) and
     the memory of every captured graph; generate_batch and serve on eight
     texts at ~5 frames per token (1/RTF, each text against its own
     generate); the merge rule's per-call and per-frame costs;
  6. the f32 engine on CUDA against the same engine on the CPU (generate,
     and a batched plan of two chunks), then generate_batch against each
     text's generate on both devices, what one phase-2 call moves on CUDA
     at another batch size or frame bucket, and serve against
     generate_batch on CUDA;
  7. training at full width (config_example.yaml: batch 5, max_len 300,
     f32): a workspace of seeded synthetic 24 kHz WAVs in two duration
     bins and a seeded random-weight checkpoint written by the port, then
     `train_loop.main` for one epoch (4 D/G steps, the eval pass, the
     epoch checkpoint), checked (finite losses, every trainable module
     moved, the pitch extractor bit-identical, 8 B2 launches and no B1
     launch per step, the backward's plain-formula calls), timed (D step,
     G step, optimizer, peak memory, one profiled step's device busy
     time), B2 forward and gradient at every training shape, one D/G step
     on CUDA against the CPU at a small config with the draws fixed, and
     the checkpoint through the inference engine;
  8. the iSTFTNet and Vocos decoders at full width (config_example.yaml
     with the decoder type changed and HiFi-GAN's upsampling keys removed,
     so the type's documented defaults apply; bf16, seeded random
     weights), each: warmup, compute_style and generate through a replayed
     fused graph, the fused graph against the two-phase path, and
     generate_batch on eight texts gated per row at twice this decoder's
     phase2_spread, with B1 counted per window (48 launches per phase-2
     evaluation for iSTFTNet, none for Vocos); for iSTFTNet the spread
     after each generator stage (istft_stages) and with the generator in
     f32 (what amplifies the batch-8-vs-1 spread?), B1 against
     its plain version at its stage shapes at frame bucket 256 (C 256 at
     T 5120 and C 128 at the odd T 30721; f32 and bf16; valid prefix
     before T and at T; with and without the residual and stats) and
     every launch of one phase-2 call timed; the f32 CUDA engine against
     the CPU (iSTFTNet gated with the CPU's source STFT shared); one
     full-width D/G step on phase 7's batch (launches, losses, ms per
     step, peak memory) and the small config's CUDA-vs-CPU step;
  9. the deployment path at full width (bf16, seeded random weights):
     reference-layout .pth files written by the port (all eight modules;
     a Vocos config's inference modules with new-style weight-norm keys),
     StyleTTS2(cfg, path) from each held bit for bit against the engine
     built from the tree (fused graphs, init time), one train_loop D/G
     step with the .pth as pretrained_model, a voices directory holding
     the style clip as WAV and as FLAC (equal styles, B2 counted), then
     tools/serve_http on 127.0.0.1 with background capture: a cold /tts
     answered two-phase, a second request while the graph is captured,
     the capture's wall time and recorded B1 count (== b1_per_eval), the
     same request through the graph (equal length), /tts_batch on the
     eight texts == generate_batch row by row (1/RTF);
 10. the SLM (WavLM) adversarial stage ("[10 slm]", f32, TF32 off):
     full-width wavlm-base-plus on CUDA against the CPU (seeded weights,
     3 s of 16 kHz audio), its HF-layout state dict loaded through
     slmadv_params.wavlm_path (bit for bit), one round at the small
     config on CUDA against the CPU (draws fixed; cuDNN off gated, on
     reported), train_loop.main with the stage on at full width on phase
     7's workspace (a round every 2 steps: each round's generator and
     discriminator ms, B2 once and B1 never, the modules it moved, peak
     memory), one round each of iSTFTNet and Vocos at full width, and the
     refusal without WavLM weights;
 11. the multi-GPU paths ("[11 parallel]", parallel/): one process per
     rank of this script (`--parallel-worker`) with torchrun's environment
     (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), the
     kernels built by this process. 11a, world size 1 over NCCL:
     `train_loop --distributed` on phase 7's workspace (2 steps; B2 8 per
     step and 7 per eval batch, B1 none), the data-parallel step against
     make_train_step on the same batch and generator state, the
     data-parallel bf16 engine's generate_batch on the eight texts against
     the single engine's generate of each (the batch gate, phase2_spread
     beside it; B1 96 per phase-2 evaluation of the rank), the f32
     seq-parallel engine against the f32 single engine on the short text
     (phase 6's f32 batch gate; the largest int16 difference), where the
     frame-sharded decode departs from a one-rank one at frame bucket 512
     (beside a one-rank decode with every AdaIN statistic moved by one
     ulp), and the ms of the data-parallel step (split at its phase
     marks), the single step, the seq-parallel and the plain decode. 11b,
     two ranks on the one card over gloo with CUDA tensors: the same
     engines at 2 ranks against 1 (the core boundaries holding no more of
     the decode's difference than their share of the frames), and the
     data-parallel step at global batch 4 (2 rows per rank, draws fixed,
     dropout off) against one process's step (rtol 2e-3, atol 3e-4);
     every rank's results equal; its times are two processes sharing one
     device, not speeds. B1 and B2 are held against their plain versions
     on the first call of each window (KernelProbe);
 12. ONNX ("[12 onnx]", onnx/): per decoder (HiFi-GAN, iSTFTNet, Vocos at
     full width, seeded random weights, f32 decoder) the engine's modules
     exported with `export_modules` (wall time, size) and evaluated by
     `onnx.runtime.OnnxModel` on CUDA on the short text with phase 5's
     style, at a speed that keeps it near 300 frames: held against the
     same graph on the CPU and against the port's modules composed as the
     graph composes them (`onnx_reference`: f32 decoder on CUDA, B1 96 /
     48 / 0 launches, KernelProbe on the window's first call), at max
     |diff| / max |want| <= 5e-3; the bf16 decoder's composition reported
     beside the decoder's phase2_spread; the graph's and the composed
     forward's wall ms;
 13. the serving export ("[13 export]", tools/export_serving.py): per
     decoder (HiFi-GAN, iSTFTNet, Vocos at full width, bf16, seeded
     random weights) `export_engine` at the (token, frame) bucket pair
     the two-phase plan takes for the short text with phase 5's style
     (export seconds, MB per file), then a process of this script that
     imports torch and the operator module only (asserted) loads the
     graphs with `load_exported` and runs phase 1, then phase 2 on the
     parent's post-processed durations: held against the live engine's
     `_phase1` / `_phase2` (phase 1 scaled max < 1e-5, PCM rel-l2 <
     2.5e-3, bit identity and the largest int16 difference printed), B1
     launched 96 / 48 / 0 times per exported phase-2 call (counted in
     that process), the registered op on CUDA against its plain version
     at one HiFi-GAN shape (phase 3's gates), and the loaded graphs' wall
     ms beside the live eager phases';
 14. the measurement tools ("[14 tools]"), each through its `main(argv)`
     in this process with its standard output captured, as its command
     line runs it: `tools/bench_train --steps 3` at the reference recipe
     (HiFi-GAN, batch 5, max_len 300, f32; an out-of-memory error fails
     the phase), then `tools/profile_inference hifigan 1`; each tool's
     output checked (the JSON keys and finite losses; every figure's line), B2's
     launches in the bench window equal to 8 per micro-batch of the warm
     and the timed steps and none of B1's, and B1's in the profile window
     96 per phase-2, decoder or generator evaluation plus the operator
     calls of its dispatch floor; the phase's and the whole script's wall
     seconds;
 15. the kernels line (JSON), the card line, and the result line.
Any failed check exits non-zero without the result line. Without a CUDA
device, or without the repository around it, it exits non-zero at once.
`--b1-only` stops after phase 3, `--deploy-only` runs phase 9 alone,
`--slm-only` phase 10 alone and `--parallel-only` phase 11 alone (each on
a fresh phase-7 workspace), `--onnx-only` phase 12 alone,
`--export-only` phase 13 alone, `--tools-only` phase 14 alone; with
`--package-from DIR` the package
(kernels, wrappers, config) comes from the checkout in DIR, so two commits'
B1 kernels are timed by the same code in one run.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
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
# rel-l2, a text's row of generate_batch against its own generate (each
# bound is about twice what one phase-2 call on identical inputs moves at
# another batch size or frame bucket on the card, which `phase2_spread`
# measures and prints beside the check): the CPU bound is the CPU tests'
REL_L2_TEST = 5e-4
BATCH_BOUND = {"float32": 2.5e-3, "bfloat16": 3e-2}
# eight single-sentence texts for generate_batch and serve, at ~5 frames
# per token: random weights predict ~24.5, so the duration head's output is
# scaled by DURATION_SCALE
BATCH_TEXTS = [
    "Hello there, how are you today?",
    "The weather is lovely this morning.",
    "Please take the second turn on the left.",
    "I will call you back in ten minutes.",
    "Our train leaves from platform nine at noon.",
    "She sells sea shells by the sea shore.",
    "Thank you for waiting, your order is ready.",
    "The museum opens at nine and closes at five.",
]
DURATION_SCALE = 0.2
# training: (first clip's samples, clips) per duration bin (4.0 and 5.0 s;
# clips step by 400 samples and stay in the bin, 20 frames = 6000 samples
# per bin); the first bin's last N_VAL clips are the validation set, so
# batch 5 gives 2 + 2 train steps and 1 eval batch
TRAIN_BINS = ((96000, 15), (120000, 10))
N_VAL = 5
B2_PER_STEP = 8  # compute_mels in the D and G steps + 6 MRSTFT
B2_PER_EVAL = 7
STEPS_TIMED = 3  # steps per timed run, without and with the phase syncs
# the small config of the CUDA-vs-CPU step (the tests' tiny config)
TRAIN_TINY = {
    "max_len": 66,
    "preprocess_params": {"spect_params": {"n_fft": 512, "win_length": 240,
                                           "hop_length": 60}},
    "model_params": {
        "hidden_dim": 64, "max_conv_dim": 64, "dim_in": 16, "style_dim": 32,
        "max_dur": 10,
        "ASR_params": {"input_dim": 80, "hidden_dim": 64, "n_layers": 2,
                       "token_embedding_dim": 64},
        "decoder": {"type": "hifigan", "upsample_initial_channel": 512,
                    "upsample_rates": [10, 6],
                    "upsample_kernel_sizes": [20, 12],
                    "resblock_kernel_sizes": [3],
                    "resblock_dilation_sizes": [[1, 3]]}},
    "tpu": {"decoder_dtype": "float32"}, "debug": False}
# CUDA vs CPU step: f32 summation order, amplified by random weights. The
# aligner's gradient bound is about twice what cuDNN's LSTM rounding moves
# it on the card (1.11e-2, phase_train_parity, which also gates the same
# step with cuDNN off at TRAIN_GRAD_REL)
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_REL = 5e-3
TRAIN_GRAD_BOUND = {"text_aligner": 2.5e-2}


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


def b2_bound(b, t, frames, n_fft, win, m):
    """Kernel B2's bound for (b, t) waves at n_fft/win/m: the function's
    own work. The Hann window is zero outside its win taps
    (ops/stft.py hann_window), so each frame's DFT needs win taps, not
    n_fft: 4 N win F operations for the two products, 2 N F M for the
    filterbank. Bytes: the waves read once, the windowed bases (2 win F)
    and the filterbank (F M) once, the mels written once."""
    n, f = b * frames, n_fft // 2 + 1
    return bound_ms(4.0 * n * win * f + 2.0 * n * f * m,
                    4.0 * (b * t + 2 * win * f + f * m + n * m), PEAK_F32)


class Checks:
    def __init__(self):
        self.failed = []

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failed.append(what)
            print(f"  FAILED: {what}", flush=True)


def b1_operands(c, t, k, dtype, gen, b=1, residual=False, full=False):
    """Random operands; row i's valid prefix ends 37 + 101 i rows before T,
    or at T itself (full)."""
    import torch

    def rnd(*shape, sc=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * sc

    ops = dict(x=rnd(b, t, c).to(dtype), scale=rnd(b, c, sc=0.5) + 1.0,
               shift=rnd(b, c, sc=0.1), alpha=rnd(c).abs() + 0.5,
               w=rnd(k, c, c, sc=0.05).to(dtype), bias=rnd(c, sc=0.01),
               n_valid=torch.tensor([t - (0 if full else 37 + 101 * i)
                                     for i in range(b)],
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


def b1_stages(dec, frame_bucket: int):
    """(C, T, [(k, dilations)]) of every generator stage whose
    AdaINResBlock1 blocks run B1 at `frame_bucket` (asr frames): T = 2F
    prod(rates[:i+1]), plus iSTFTNet's reflection-pad row at its last
    stage; the noise_res block (k 7, or 11 at the last stage) first."""
    if dec.type == "vocos":
        return []
    rates, n_up = dec.upsample_rates, len(dec.upsample_rates)
    stages = []
    for i in range(n_up):
        last = i + 1 == n_up
        c = dec.upsample_initial_channel // 2 ** (i + 1)
        t = 2 * frame_bucket * int(np.prod(rates[: i + 1]))
        t += int(last and dec.type == "istftnet")
        blocks = [(11 if last else 7, (1, 3, 5))]
        blocks += [(k, tuple(ds)) for k, ds in
                   zip(dec.resblock_kernel_sizes, dec.resblock_dilation_sizes)]
        stages.append((c, t, blocks))
    return stages


def b1_per_eval(dec) -> int:
    """B1 launches per phase-2 evaluation: two per dilation of every
    AdaINResBlock1 (96 hifigan, 48 istftnet, 0 vocos at full width)."""
    return sum(2 * len(dl) for _, _, blocks in b1_stages(dec, 1)
               for _, dl in blocks)


class B1Compare:
    """Kernel B1 against its plain version on the same random operands,
    within TOL (and STATS_TOL for the stats) of max(1, max |plain|)."""

    def __init__(self, chk: Checks, gen):
        self.chk, self.gen = chk, gen
        self.max_err, self.n = 0.0, 0

    def __call__(self, c, t, k, d, dtype, residual, stats, tag="", b=1,
                 full=False):
        import torch
        from styletts2_tpu_torch.ops import vocoder_kernel as VK

        o = b1_operands(c, t, k, dtype, self.gen, b=b, residual=residual,
                        full=full)
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
        self.max_err = max(self.max_err, err)
        self.n += 1
        nv = "T" if full else "T-37"
        self.chk.check(ok, f"B1 C={c} T={t} k={k} d={d} {name} res={residual}"
                           f" stats={stats} n_valid={nv}{tag}: err {err:.3g} "
                           f"vs max {scale:.3g}")
        return err, scale


def phase_b1(chk: Checks, cfg, frame_bucket: int):
    """Checks at every (C, k, d) of the config; then times every launch of
    one bf16 phase-2 call at `frame_bucket`."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    stages = b1_stages(cfg.model_params.decoder, frame_bucket)
    compare = B1Compare(chk, gen)
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
    # the batches generate_batch and serve run in phase 5 (8 texts in one
    # phase-2 call at this frame bucket) and phase 6 (f32, 4 texts)
    for c, t, blocks in stages:
        k = max(k for k, _ in blocks)
        compare(c, t, k, 5, torch.bfloat16, True, True, tag=" (B=8)", b=8)
        compare(c, t, k, 5, torch.float32, True, True, tag=" (B=4)", b=4)
    print(f"[3 B1] {compare.n} checks in {time.perf_counter() - t0:.1f} s, "
          f"max abs err {compare.max_err:.4g}", flush=True)
    from styletts2_tpu_torch.ops import _build

    counts, line = tensor_core_sass(_build.library_path("vocoder"))
    print(f"[3 B1 sass] {line}", flush=True)
    if counts is not None:
        chk.check(counts["HGMMA"] + counts["HMMA"] > 0,
                  "B1 library has tensor-core instructions")
    return dict(max_abs_err=compare.max_err,
                **b1_times(stages, gen, "[3 B1 time]",
                           f"one bf16 phase-2 call at frame bucket "
                           f"{frame_bucket}"))


def b1_times(stages, gen, tag: str, what: str):
    """Every B1 launch of one bf16 phase-2 call over `stages`, timed: per
    dilation, conv1 (stats) and conv2 (residual + stats, no stats after
    the last). ms: CUDA events around 10 eager wrapper calls (the
    definition of earlier PRs; it includes the host's time to issue each
    call); device ms: CUDA-graph replay of the same inputs (warm L2); cold
    ms: replay cycling through input sets that together exceed twice the
    L2, so inputs come from HBM as the bound assumes; plain ms: eager."""
    import torch
    from styletts2_tpu_torch.ops import vocoder_kernel as VK

    launches = {}
    for c, t, blocks in stages:
        for k, dl in blocks:
            for j, d in enumerate(dl):
                last = j == len(dl) - 1
                for key in ((c, t, k, d, False, True),
                            (c, t, k, 1, True, not last)):
                    launches[key] = launches.get(key, 0) + 1
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
        print(f"{tag} bf16 C={c} T={t}: {int(ps['n'])} launches, "
              f"{times(ps)}", flush=True)
    by = "operations" if totals["ops_ms"] >= totals["bound_ms"] / 2 else "bytes"
    print(f"{tag} {what}: {totals['n']} launches, {times(totals)} ({by})",
          flush=True)
    return dict(bound_by=by, detail=detail, launches=totals["n"],
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
        bms, by = b2_bound(b, t, got.shape[2], n_fft, win, m)
        out[name] = dict(ms=ems, device_ms=dms, plain_ms=pms, bound_ms=bms,
                         bound_by=by)
        print(f"[4 B2] {name} ({b}x{t}, n_fft {n_fft}, {m} mels, {n} "
              f"frames): max abs err {err:.3g} (atol 2e-5 + rtol 1e-4), "
              f"kernel {ems:.3f} ms in eager calls, {dms:.3f} ms on the "
              f"device; plain {pms:.3f} ms, bound {bms:.4f} ms ({by})",
              flush=True)
    return dict(max_abs_err=max_err, shapes=out, **out["style B=1"])


KERNEL_NAMES = {"b1": "ada_snake_conv", "b2": "log_mel"}


def launches():
    """{b1, b2}: the process's launch counts (ops/launch_count: the
    wrappers' launches plus what each graph replay recorded at capture; a
    capture's own wrapper calls launch nothing and are not counted)."""
    from styletts2_tpu_torch.ops import launch_count as LC

    return {k: LC.get(name) for k, name in KERNEL_NAMES.items()}


class Launches:
    """The kernel launches of one window of the engine's work: the counts,
    the engine's eager phase-2 evaluations and its graph replays are set to
    0 when the window opens; `read` also gives the graphs captured in the
    window."""

    def __init__(self, engine):
        from styletts2_tpu_torch.ops import launch_count as LC

        LC.reset()
        self.engine = engine
        engine.phase2_calls = engine.graph_replays = 0
        self.graphs = set(engine.graphs)

    def read(self):
        e = self.engine
        return dict(phase2_calls=e.phase2_calls, replays=e.graph_replays,
                    captures=len(set(e.graphs) - self.graphs), **launches())


def check_b1_counts(chk: Checks, c, what: str, per_eval: int) -> None:
    """B1 launched `per_eval` times (b1_per_eval: 96 hifigan, 48 istftnet,
    0 vocos) per eager phase-2 evaluation (a background capture's warm-up
    call among them) and per graph replay."""
    chk.check(c["b1"] == per_eval * (c["phase2_calls"] + c["replays"])
              and (c["b1"] > 0) == (per_eval > 0), f"{what}: B1 launches {c}")


def timed(fn):
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def phase2_spread(engine, text: str, style, probes: bool = True):
    """What one phase-2 call moves on this device when only its batch or
    frame bucket changes: one text's phase 2 on identical inputs at batch 1
    on its frame bucket (the reference), at the next frame bucket and at
    batch 8 (rel-l2 over the text's samples); the rel-l2 of the batch-8
    run's F0 curve against batch 1's; the decoder alone at batch 1 fed the
    batch-8 run's F0 and N (is the F0/N path what moves?); batch 8
    against batch 1 again with B1's plain version in place of the kernel,
    and with cuDNN off (is either of them what moves?); for iSTFTNet also
    with one source STFT, batch 1's, fed to both runs through
    ISTFTNetGenerator.source_features (is the source's branch-cut phase
    what moves?), and batch 8's row 0 against batch 1 after each stage of
    the generator (istft_stages: which stage amplifies?). probes=False:
    the buckets and batch 8 only."""
    import torch
    from styletts2_tpu_torch.infer import _bucket
    from styletts2_tpu_torch.ops import vocoder_kernel as VK
    from styletts2_tpu_torch.text import tokens_for_sentence

    e = engine
    tk = tokens_for_sentence(text, e.cleaner)
    tb = _bucket(e.cfg.tpu.token_buckets, len(tk))
    fbs = e.cfg.tpu.frame_buckets
    with torch.inference_mode():
        tokens = torch.zeros(1, tb, dtype=torch.int64, device=e.device)
        tokens[0, : len(tk)] = torch.tensor(tk, device=e.device)
        mask = torch.zeros(1, tb, dtype=torch.bool, device=e.device)
        mask[0, : len(tk)] = True
        s = e._style_row(style["style"])
        t_en, d, dur = e._phase1(tokens, mask, s)
        pred, _ = e._postprocess_durations(
            dur[0, : len(tk)].cpu().numpy(), 1.0, 0.0, 0.0, None)
        durs = torch.zeros(1, tb, dtype=torch.int32, device=e.device)
        durs[0, : len(tk)] = torch.from_numpy(pred).to(e.device)
        frames = int(pred.sum())
        fb = _bucket(fbs, frames)
        n = frames * 2 * e.hop

        def run(b, f):
            sb = s.expand(b, -1)
            pros = e._prosody(*(x.expand(b, *x.shape[1:]).contiguous()
                                for x in (t_en, d)), sb,
                              durs.expand(b, -1).contiguous(), f)
            pcm = e._decode(pros[0], pros[1], pros[2], sb, pros[3])
            return pros, pcm[0, :n].float().cpu().numpy()

        (asr1, f0_1, n_1, m1), ref = run(1, fb)
        _, nxt = run(1, fbs[fbs.index(fb) + 1])
        (_, f0_8, n_8, _), b8 = run(8, fb)
        out = dict(frames=frames, frame_bucket=fb,
                   next_bucket=rel_l2(nxt, ref), batch8=rel_l2(b8, ref))
        if not probes:
            return out
        fed = e._decode(asr1, f0_8[:1], n_8[:1], s, m1)[0, :n].float()
        out.update(f0=rel_l2(f0_8[0].float().cpu().numpy(),
                             f0_1[0].float().cpu().numpy()),
                   decoder_fed_batch8_f0n=rel_l2(fed.cpu().numpy(), ref))
        dc = e.cfg.model_params.decoder
        if dc.type == "istftnet":
            gen = e.modules["decoder"].generator
            n_up, n_k = len(dc.upsample_rates), len(dc.resblock_kernel_sizes)

            def staged(b):
                got = []
                hook = gen.register_forward_hook(
                    lambda mod, args, o: got.append(o))
                try:
                    with istft_taps(dc.gen_istft_n_fft) as rec:
                        run(b, fb)
                finally:
                    hook.remove()
                return istft_stages(rec, n_up, n_k, dc.gen_istft_n_fft,
                                    got[-1])

            out["stages"], out["first_amplifying_stage"] = stage_moves(
                staged(8), staged(1), frames / fb)

        @contextlib.contextmanager
        def plain_b1():
            kernel = VK.ada_snake_conv
            VK.ada_snake_conv = VK.ada_snake_conv_plain
            try:
                yield
            finally:
                VK.ada_snake_conv = kernel

        @contextlib.contextmanager
        def shared_source():
            from styletts2_tpu_torch.nn.istftnet import ISTFTNetGenerator

            features = ISTFTNetGenerator.source_features
            kept = []

            def shared(self, f0, source=None):
                out["source_calls"] = out.get("source_calls", 0) + 1
                if not kept:
                    kept.append(features(self, f0, source))
                return kept[0].expand(f0.shape[0], -1, -1).contiguous()

            ISTFTNetGenerator.source_features = shared
            try:
                yield
            finally:
                ISTFTNetGenerator.source_features = features

        ctxs = [("batch8_plain_b1", plain_b1),
                ("batch8_cudnn_off",
                 lambda: torch.backends.cudnn.flags(enabled=False))]
        if e.cfg.model_params.decoder.type == "istftnet":
            ctxs.append(("batch8_shared_source", shared_source))
        for name, ctx in ctxs:
            with ctx():
                one = run(1, fb)[1]  # batch 1 first: it sets the source
                out[name] = rel_l2(run(8, fb)[1], one)
        return out


ISTFT_STAGE_AMPLIFIES = 3.0  # a stage that moves > 3x its input's move


@contextlib.contextmanager
def istft_taps(n_fft: int):
    """Record what ISTFTNetGenerator's stages compute while the block runs:
    every `layers.conv_transpose1d` output (the upsamples), every
    AdaINResBlock1 output (per stage the noise_res block, then the
    resblocks) and every conv output with n_fft + 2 channels (conv_post).
    `istft_stages` names them."""
    from styletts2_tpu_torch.nn import blocks as NB
    from styletts2_tpu_torch.nn import layers as NL

    rec = {"up": [], "block": [], "post": []}
    conv_t, conv = NL.conv_transpose1d, NL.conv1d
    fwd = NB.AdaINResBlock1.forward

    def tap_conv_t(mod, x):
        rec["up"].append(conv_t(mod, x))
        return rec["up"][-1]

    def tap_conv(mod, x):
        y = conv(mod, x)
        if y.shape[-1] == n_fft + 2:
            rec["post"].append(y)
        return y

    def tap_block(self, *a, **kw):
        rec["block"].append(fwd(self, *a, **kw))
        return rec["block"][-1]

    NL.conv_transpose1d, NL.conv1d = tap_conv_t, tap_conv
    NB.AdaINResBlock1.forward = tap_block
    try:
        yield rec
    finally:
        NL.conv_transpose1d, NL.conv1d = conv_t, conv
        NB.AdaINResBlock1.forward = fwd


def istft_stages(rec, n_up: int, n_k: int, n_fft: int, out):
    """{stage: (B, T, C) f32 numpy} in the generator's order from one
    `istft_taps` record (the last generator call's): up{i}, the upsample's
    output; res{i}, the stage's resblock sum / n_k; logmag and phase,
    conv_post's halves before the f32 cast; exp of the magnitude; sin of
    the phase; istft, the output `out`; pcm, `out` clipped to [-1, 1] as
    the engine clips it before the int16 cast."""
    def np32(t):
        return t.detach().float().cpu().numpy()

    blocks = rec["block"][-n_up * (1 + n_k):]
    st = {}
    for i, up in enumerate(rec["up"][-n_up:]):
        st[f"up{i}"] = np32(up)
        rbs = blocks[i * (1 + n_k) + 1: (i + 1) * (1 + n_k)]
        st[f"res{i}"] = np32(sum(r.float() for r in rbs) / n_k)
    post = rec["post"][-1]
    half = n_fft // 2 + 1
    st["logmag"], st["phase"] = np32(post[..., :half]), np32(post[..., half:])
    st["exp"] = np.exp(st["logmag"])
    st["sin"] = np.sin(st["phase"])
    st["istft"] = np32(out)
    st["pcm"] = np.clip(st["istft"], -1.0, 1.0)  # the engine's int16 clip
    return st


# each stage of istft_stages and the stage it reads (exp and sin read
# conv_post's halves; the iSTFT reads both)
STAGE_INPUTS = {"res0": ("up0",), "up1": ("res0",), "res1": ("up1",),
                "logmag": ("res1",), "phase": ("res1",), "exp": ("logmag",),
                "sin": ("phase",), "istft": ("exp", "sin"),
                "pcm": ("istft",)}


def stage_moves(a, b, frac: float):
    """rel-l2 of row 0 of each stage of `a` against `b` over its valid
    prefix (ceil(rows * frac) rows, frac = valid / bucket frames), and the
    first stage that moves more than ISTFT_STAGE_AMPLIFIES x the larger
    move of the stages it reads (STAGE_INPUTS; not counted after stages
    that did not move at all)."""
    moves = {}
    for k in a:
        n = int(np.ceil(a[k].shape[1] * frac))
        moves[k] = rel_l2(a[k][0, :n], b[k][0, :n])
    first = next((k for k, ins in STAGE_INPUTS.items()
                  if k in moves and all(i in moves for i in ins)
                  and 0 < ISTFT_STAGE_AMPLIFIES * max(moves[i] for i in ins)
                  < moves[k]), None)
    return moves, first


def spread_line(sp) -> str:
    return (f"one text's phase 2 on identical inputs ({sp['frames']} frames,"
            f" bucket {sp['frame_bucket']}): next bucket rel-l2 "
            f"{sp['next_bucket']:.3g}, batch 8 {sp['batch8']:.3g} (with B1's "
            f"plain version {sp['batch8_plain_b1']:.3g}, with cuDNN off "
            f"{sp['batch8_cudnn_off']:.3g}"
            + (f", with batch 1's source STFT shared "
               f"{sp['batch8_shared_source']:.3g} ({sp['source_calls']} "
               f"calls took it)"
               if "batch8_shared_source" in sp else "")
            + f"); batch 8's F0 vs batch 1's "
            f"{sp['f0']:.3g}, the decoder at batch 1 fed batch 8's F0/N "
            f"{sp['decoder_fed_batch8_f0n']:.3g}"
            + (f"; batch 8's row vs batch 1 after each generator stage "
               + ", ".join(f"{k} {v:.3g}" for k, v in sp["stages"].items())
               + f" (first stage > {ISTFT_STAGE_AMPLIFIES:g}x the stages it "
               f"reads: {sp['first_amplifying_stage']})" if "stages" in sp
               else ""))


def style_clip(sr: int) -> np.ndarray:
    """A seeded 5-s reference clip: a tremolo tone in noise."""
    rng = np.random.default_rng(0)
    tt = np.arange(sr * 5) / sr
    return (0.3 * np.sin(2 * np.pi * 180 * tt) * (1 + np.sin(2 * np.pi * 3 * tt))
            + 0.05 * rng.standard_normal(len(tt))).astype(np.float32)


def phase_engine(chk: Checks, cfg, card: str):
    """The full-width bf16 engine through its entry points: compute_style
    and generate on three texts (the short one through a replayed fused
    graph), the fused graph against the two-phase path, generate_batch and
    serve on eight texts, and the merge constants. Returns the launches of
    every window, by kernel."""
    import torch
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.text import tokens_for_sentence

    t0 = time.perf_counter()
    engine = StyleTTS2(cfg, seed=0)  # CUDA, bf16 decoder from the config
    print(f"[5 engine] init {time.perf_counter() - t0:.1f} s, decoder "
          f"{engine.dtype}, {sum(p.numel() for p in engine.modules.parameters())}"
          f" parameters", flush=True)
    sr = engine.sr
    clip = style_clip(sr)
    # warm-up (cuDNN plans, first launches, the fused graphs the texts
    # pick, the speaking-rate estimate) before the counted run
    style = {"style": engine.compute_style(clip), "speed": 1.0}
    _, wall = timed(lambda: engine.warmup(token_buckets=(64,),
                                          frame_buckets=(904,)))
    print(f"[5 engine] warmup (token bucket 64, frame bucket 904): "
          f"{wall:.1f} s, fused graphs captured at (token, frame) buckets "
          f"{sorted(engine.graphs)}", flush=True)
    chk.check(len(engine.graphs) >= 1, "warmup captured the fused graphs")
    for _ in range(2):
        for text in TEXTS.values():
            engine.generate(text, style)
    torch.cuda.synchronize()

    windows = {}
    win = Launches(engine)
    ref_s, wall = timed(lambda: engine.compute_style(clip))
    print(f"[5 engine] compute_style 5-s clip: {wall * 1e3:.1f} ms, style "
          f"{tuple(ref_s.shape)} finite "
          f"{bool(torch.isfinite(ref_s).all())} | {card}", flush=True)
    chk.check(bool(torch.isfinite(ref_s).all()), "style finite")
    style = {"style": ref_s, "speed": 1.0}
    for name, text in TEXTS.items():
        calls0, replays0 = engine.phase2_calls, engine.graph_replays
        wav, wall = timed(lambda: engine.generate(text, style))
        secs = len(wav) / sr
        finite = bool(np.isfinite(wav).all())
        edges = (np.abs(wav[:4000]).max() == 0 and np.abs(wav[-4000:]).max() == 0)
        audible = float(np.abs(wav[4000:-4000]).max()) if len(wav) > 8000 else 0.0
        chk.check(finite and edges and len(wav) > 8000 and audible > 0
                  and np.abs(wav).max() <= 1.0, f"generate {name}")
        print(f"[5 engine] generate {name}: {len(wav)} samples "
              f"({secs:.2f} s audio), finite {finite}, peak {audible:.3f}, "
              f"{engine.phase2_calls - calls0} eager phase-2 calls, "
              f"{engine.graph_replays - replays0} graph replays, wall "
              f"{wall * 1e3:.1f} ms, 1/RTF {secs / wall:.1f} | {card}",
              flush=True)
    windows["generate"] = c = win.read()
    print(f"[5 engine] launches (compute_style + generate x3): {c}",
          flush=True)
    per_eval = b1_per_eval(engine.cfg.model_params.decoder)
    check_b1_counts(chk, c, "generate", per_eval)
    chk.check(c["replays"] >= 1, "the short text replayed a fused graph")
    chk.check(c["b2"] >= 1, "B2 launched on the main path")
    chk.check(all(g.launches.get("ada_snake_conv", 0) == per_eval
                  for g in engine.graphs.values()),
              f"every fused graph recorded {per_eval} B1 launches")

    # n_merge=1: one chunk per sentence (the default merges the short
    # sentences of this text into one chunk)
    engine._rng = np.random.default_rng(9)
    full = engine.generate(TEXTS["multi"], style, n_merge=1)
    engine._rng = np.random.default_rng(9)
    segs = list(engine.generate_stream(TEXTS["multi"], style, n_merge=1))
    same = np.array_equal(np.concatenate(segs), full)
    chk.check(same and len(segs) > 1, "concatenate(generate_stream) == "
              "generate")
    print(f"[5 engine] generate_stream multi: {len(segs)} segments, "
          f"concatenated == generate {same}", flush=True)

    fused = phase_fused(chk, engine, style, card)
    batch = phase_batch(chk, engine, style, card, windows)
    merge = phase_merge_constants(engine, style, card)
    return windows, dict(fused=fused, batch=batch, merge=merge)


def phase_fused(chk: Checks, engine, style, card: str, tag="[5 fused]"):
    """The short text through the fused graph against the two-phase path:
    graph replay vs the same engine's eager `_fused` (identical), the same
    total as the two-phase path from the same seed, five runs of each path
    (median wall, 1/RTF), and the memory of every captured graph."""
    import torch
    from styletts2_tpu_torch.text import tokens_for_sentence

    text, sr = TEXTS["short"], engine.sr
    out = {}
    for fused in (True, False):
        engine.fused_enabled = fused
        engine._rng = np.random.default_rng(7)
        replays0 = engine.graph_replays
        ref, _ = timed(lambda: engine.generate(text, style))
        walls = [timed(lambda: engine.generate(text, style))[1]
                 for _ in range(5)]
        name = "fused graph" if fused else "two-phase"
        med = float(np.median(walls))
        out[name] = dict(samples=len(ref), walls_ms=[w * 1e3 for w in walls],
                         median_ms=med * 1e3,
                         inv_rtf=len(ref) / sr / med,
                         replays=engine.graph_replays - replays0)
        print(f"{tag} short text, {name}: {len(ref)} samples, 5 runs "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median "
              f"{med * 1e3:.1f} ms, 1/RTF {len(ref) / sr / med:.1f}, "
              f"{engine.graph_replays - replays0} graph replays | {card}",
              flush=True)
    engine.fused_enabled = True
    chk.check(out["fused graph"]["replays"] == 6,
              f"{tag} every fused run replayed a graph")
    chk.check(out["two-phase"]["replays"] == 0, f"{tag} fused_enabled=False")
    chk.check(out["fused graph"]["samples"] == out["two-phase"]["samples"],
              f"{tag} fused and two-phase totals equal")

    tk = tokens_for_sentence(text, engine.cleaner)
    for (tb, fb), g in sorted(engine.graphs.items()):
        tokens = np.zeros((1, tb), np.int64)
        tokens[0, : len(tk)] = tk
        mask = np.zeros((1, tb), bool)
        mask[0, : len(tk)] = True
        noise = np.zeros((1, tb), np.float32)
        noise[0, : len(tk)] = np.random.default_rng(1).standard_normal(len(tk))
        scal = np.array([1.0, 0.0, 0.0, 1.0, 0.2, 0.0], np.float32)
        pcm, total = (a.copy() for a in engine._replay_fused(
            tokens, mask, style["style"], scal, noise, fb))
        with torch.inference_mode():
            want = engine._fused(*(torch.from_numpy(a).cuda()
                                   for a in (tokens, mask)), style["style"],
                                 torch.from_numpy(scal).cuda(),
                                 torch.from_numpy(noise).cuda(), n_frames=fb)
        same = (np.array_equal(pcm, want[0].cpu().numpy())
                and np.array_equal(total, want[1].cpu().numpy()))
        chk.check(same, f"{tag} graph ({tb}, {fb}) == eager _fused")
        print(f"{tag} graph (token bucket {tb}, frame bucket {fb}): "
              f"replay == eager _fused {same} (total {int(total[0])}); "
              f"peak allocated while capturing "
              f"{g.peak_bytes / 2 ** 20:.1f} MiB, shared pool grew "
              f"{g.pool_growth_bytes / 2 ** 20:.1f} MiB | {card}", flush=True)
    out["graphs"] = {f"{tb},{fb}": dict(peak_mib=g.peak_bytes / 2 ** 20,
                                        pool_growth_mib=g.pool_growth_bytes
                                        / 2 ** 20)
                     for (tb, fb), g in engine.graphs.items()}
    return out


def phase_batch(chk: Checks, engine, style, card: str, windows):
    """generate_batch and serve on eight texts at ~5 frames per token
    (duration_scale; random weights predict ~24.5), stabilize=False so each
    text's output can be set beside its own generate."""
    from styletts2_tpu_torch.text import tokens_for_sentence

    sr, hop = engine.sr, engine.hop
    engine.duration_scale = DURATION_SCALE
    texts = BATCH_TEXTS
    n_tok = [len(tokens_for_sentence(t, engine.cleaner)) for t in texts]
    engine.generate_batch(texts, style, stabilize=False)  # warm-up
    win = Launches(engine)
    runs = [timed(lambda: engine.generate_batch(texts, style,
                                                stabilize=False))
            for _ in range(3)]
    windows["generate_batch"] = c = win.read()
    per_eval = b1_per_eval(engine.cfg.model_params.decoder)
    check_b1_counts(chk, c, "generate_batch x3", per_eval)
    outs = runs[0][0]
    chk.check(all(np.array_equal(x, y) for r in runs[1:]
                  for x, y in zip(r[0], outs)), "generate_batch repeats")
    wall = float(np.median([r[1] for r in runs]))
    secs = sum(len(w) for w in outs) / sr
    fpt = sum(len(w) for w in outs) / (2 * hop) / sum(n_tok)
    print(f"[5 batch] generate_batch {len(texts)} texts ({sum(n_tok)} "
          f"tokens, "
          f"duration_scale {DURATION_SCALE}: {fpt:.2f} frames per token): "
          f"{secs:.2f} s audio, 3 runs "
          f"{', '.join(f'{r[1] * 1e3:.1f}' for r in runs)} ms, median "
          f"1/RTF {secs / wall:.1f}, {c['phase2_calls'] // 3} phase-2 calls"
          f" each | {card}", flush=True)
    rel = []
    for text, got in zip(texts, outs):
        want = engine.generate(text, style, stabilize=False)
        ok = got.shape == want.shape and np.isfinite(got).all()
        rel.append(rel_l2(got, want) if ok else 1.0)
    bound = BATCH_BOUND["bfloat16"]
    spread = phase2_spread(engine, texts[0], style)
    chk.check(max(rel) < bound, f"bf16 generate_batch vs generate rel-l2 "
              f"{rel}")
    print(f"[5 batch] each text vs its own generate (fused graph): lengths "
          f"equal, rel-l2 {', '.join(f'{r:.3g}' for r in rel)} (bound "
          f"{bound:g}); {spread_line(spread)}", flush=True)
    n_batches = 4
    batches = [texts] * n_batches
    list(engine.serve(batches[:2], style, stabilize=False))  # warm-up
    win = Launches(engine)
    served, wall = timed(lambda: list(engine.serve(batches, style,
                                                   stabilize=False)))
    windows["serve"] = c = win.read()
    check_b1_counts(chk, c, "serve", per_eval)
    secs_all = n_batches * secs
    same = all(len(a) == len(b) and all(np.array_equal(x, y)
                                        for x, y in zip(a, b))
               for a, b in zip(served, [outs] * n_batches))
    chk.check(same and len(served) == n_batches, "serve == generate_batch")
    print(f"[5 batch] serve {n_batches} batches x {len(texts)} texts: "
          f"{secs_all:.2f} s audio in {wall * 1e3:.1f} ms, 1/RTF "
          f"{secs_all / wall:.1f}, each batch == generate_batch {same} | "
          f"{card}", flush=True)
    engine.duration_scale = None
    return dict(frames_per_token=fpt, batch_inv_rtf=secs / np.median(
        [r[1] for r in runs]), serve_inv_rtf=secs_all / wall, rel_l2=rel,
        spread=spread)


def phase_merge_constants(engine, style, card: str):
    """The costs of the frame-bucket merge rule on this card, from eager
    phase-2 calls (wall, synced, median of 3) at two frame buckets: one
    more row costs (t16 - t8) / (8 F) per frame (at batch 8-16 the device,
    not the host, is the longer path), and a call costs t1 minus the
    frames of its one row."""
    import torch

    s = style["style"]
    dev = engine.device
    t = {}
    with torch.inference_mode():
        for fb in (256, 512):
            for b in (1, 8, 16):
                tokens = torch.zeros(b, 64, dtype=torch.int64, device=dev)
                mask = torch.ones(b, 64, dtype=torch.bool, device=dev)
                t_en, d, _ = engine._phase1(tokens, mask, s)
                durs = torch.full((b, 64), fb // 64, dtype=torch.int32,
                                  device=dev)
                run = lambda: engine._phase2(t_en, d, s, durs, fb)
                timed(run)
                t[(fb, b)] = float(np.median([timed(run)[1] * 1e3
                                              for _ in range(3)]))
    row = float(np.mean([(t[(fb, 16)] - t[(fb, 8)]) / (8 * fb)
                         for fb in (256, 512)]))
    call = float(np.mean([t[(fb, 1)] - fb * row for fb in (256, 512)]))
    print("[5 merge] eager phase-2 ms: " + ", ".join(
        f"F={fb} B={b} {v:.2f}" for (fb, b), v in sorted(t.items()))
        + f"; per call {call:.2f} ms, per row {row:.4f} ms per frame | "
        f"{card}", flush=True)
    return dict(call_ms=call, row_ms_per_frame=row,
                phase2_ms={f"{fb},{b}": v for (fb, b), v in t.items()})


def phase_f32_vs_cpu(chk: Checks, cfg):
    """The f32 engine on CUDA against the same engine on the CPU (generate
    on one chunk, a batched two-phase plan of two chunks), then
    generate_batch against each text's own generate on both devices (with
    what one phase-2 call moves on CUDA at another batch size or bucket)
    and serve against generate_batch on CUDA: f32, where random weights do
    not amplify bf16 rounding."""
    import copy

    import torch
    from styletts2_tpu_torch.infer import StyleTTS2

    text = "Hello there"
    pair = ["Hello there", "How are you"]
    out, engines = {}, {}
    for dev in ("cuda", "cpu"):
        engine = StyleTTS2(copy.deepcopy(cfg), seed=3, decoder_dtype="float32",
                           device=dev)
        engines[dev] = engine
        n_tok = len(engine.cleaner(text)) + 2
        engine.fixed_duration = cfg.tpu.frame_buckets[0] // n_tok
        s = np.random.default_rng(3).standard_normal((1, 128)).astype(
            np.float32) * 0.3
        t0 = time.perf_counter()
        out[dev] = engine.generate(text, {"style": s}, stabilize=False)
        out[dev + " pair"], _, _ = engine._synthesize_chunks(
            pair, s, 1.0, 0.0, 0.0, base_seed=0)
        print(f"[6 f32] {dev}: {len(out[dev])} samples + a batched plan of "
              f"{len(pair)} chunks in {time.perf_counter() - t0:.1f} s "
              f"({n_tok} tokens x {engine.fixed_duration} frames)", flush=True)

    a, b = out["cuda"], out["cpu"]
    rel = rel_l2(a, b)
    ok = a.shape == b.shape and rel < F32_CPU_BOUND and np.abs(b).max() > 0
    chk.check(ok, f"f32 CUDA vs CPU rel-l2 {rel:.3g}")
    rels = [rel_l2(x, y) for x, y in zip(out["cuda pair"], out["cpu pair"])]
    chk.check(all(x.shape == y.shape for x, y in zip(out["cuda pair"],
                                                     out["cpu pair"]))
              and max(rels) < F32_CPU_BOUND,
              f"f32 batched plan CUDA vs CPU rel-l2 {rels}")
    print(f"[6 f32] CUDA vs CPU engine, frame bucket "
          f"{cfg.tpu.frame_buckets[0]}: generate rel-l2 {rel:.3g}, batched "
          f"plan of 2 chunks rel-l2 {', '.join(f'{r:.3g}' for r in rels)} "
          f"(bound {F32_CPU_BOUND:g})", flush=True)

    st = {"style": s}
    for dev, texts, bound in (("cuda", BATCH_TEXTS[:4], BATCH_BOUND["float32"]),
                              ("cpu", BATCH_TEXTS[:2], REL_L2_TEST)):
        engine = engines[dev]
        engine.fixed_duration = None
        engine.duration_scale = DURATION_SCALE
        t0 = time.perf_counter()
        batch = engine.generate_batch(texts, st, stabilize=False)
        rels = []
        for t, got in zip(texts, batch):
            want = engine.generate(t, st, stabilize=False)
            rels.append(rel_l2(got, want) if got.shape == want.shape else 1.0)
        chk.check(max(rels) < bound, f"f32 {dev} generate_batch vs generate "
                  f"rel-l2 {rels}")
        spread = (spread_line(phase2_spread(engine, texts[0], st))
                  if dev == "cuda" else "")
        print(f"[6 f32] {dev} generate_batch ({len(texts)} texts) vs each "
              f"generate: rel-l2 {', '.join(f'{r:.3g}' for r in rels)} "
              f"(bound {bound:g}; {time.perf_counter() - t0:.1f} s) {spread}",
              flush=True)
    engine = engines["cuda"]
    texts = BATCH_TEXTS[:4]
    engine._rng = np.random.default_rng(5)
    want = [engine.generate_batch(b, st) for b in (texts[:2], texts[2:])]
    engine._rng = np.random.default_rng(5)
    got = list(engine.serve([texts[:2], texts[2:]], st))
    same = all(np.array_equal(x, y) for gb, wb in zip(got, want)
               for x, y in zip(gb, wb)) and len(got) == 2
    chk.check(same, "f32 serve == generate_batch")
    print(f"[6 f32] CUDA serve == generate_batch {same}", flush=True)


def train_workspace(ws: Path, cfg_src: Path) -> Path:
    """Seeded synthetic 24 kHz WAVs (a harmonic tone with vibrato, tremolo
    and noise) in the TRAIN_BINS, train and val lists of random words, and
    the config at cfg_src pointed at them and at ws/seed.ckpt, with
    batch_size 5, max_len 300, one epoch. Returns the config's path."""
    import yaml

    from styletts2_tpu_torch import audio as AUD

    shutil.rmtree(ws, ignore_errors=True)
    (ws / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(11)
    letters = list("abcdefghijklmnopqrstuvwxyzðəɪʊŋɹʃθ")
    train, val = [], []
    for b, (first, n_clips) in enumerate(TRAIN_BINS):
        for i in range(n_clips):
            n = first + 400 * i
            t = np.arange(n) / 24000.0
            f0 = rng.uniform(100, 220) * (1 + 0.05 * np.sin(2 * np.pi * 5 * t))
            phase = 2 * np.pi * np.cumsum(f0) / 24000.0
            wav = sum(np.sin(h * phase) / h for h in range(1, 6)) * 0.15
            wav = (wav * (0.6 + 0.4 * np.sin(2 * np.pi * 1.5 * t))
                   + 0.01 * rng.standard_normal(n))
            name = f"wavs/b{b}_{i:02d}.wav"
            AUD.write_wav(str(ws / name), wav.astype(np.float32))
            words = ["".join(rng.choice(letters, rng.integers(2, 7)))
                     for _ in range(rng.integers(8, 12))]
            line = f"{name}|{' '.join(words)}.\n"
            (val if b == 0 and i >= n_clips - N_VAL else train).append(line)
    (ws / "train_list.txt").write_text("".join(train))
    (ws / "val_list.txt").write_text("".join(val))
    raw = yaml.safe_load(cfg_src.read_text())
    raw.update(log_dir=str(ws / "runs"), save_freq=1, log_interval=1,
               epochs=1, batch_size=5, max_len=300, debug=False,
               pretrained_model=str(ws / "seed.ckpt"), load_only_params=True,
               data_params=dict(train_data=str(ws / "train_list.txt"),
                                val_data=str(ws / "val_list.txt"),
                                root_path=str(ws)))
    path = ws / "config.yaml"
    path.write_text(yaml.safe_dump(raw, allow_unicode=True))
    return path


def moved_modules(net_before, modules):
    """{module: whether any of its tensors differs from net_before}."""
    import torch

    from styletts2_tpu_torch import weights as W

    out = {}
    for k, m in modules.items():
        before = W.tree_to_state_dict(net_before[k], fuse=False)
        out[k] = any(not torch.equal(before[n], v.detach().cpu())
                     for n, v in m.state_dict().items())
    return out


def phase_train(chk: Checks, root: Path, card: str):
    """Training at full width through train_loop.main, then its checks,
    times and profile, B2 at the training shapes, the CUDA-vs-CPU step and
    the engine on the trained checkpoint. Returns (launch counts of the
    main run, the measurements)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from styletts2_tpu_torch import train_loop
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.checkpoint import save_checkpoint
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.data.loader import collate
    from styletts2_tpu_torch.models import build_model
    from styletts2_tpu_torch.ops import launch_count as LC
    from styletts2_tpu_torch.ops import mel_kernel as MK
    from styletts2_tpu_torch.train import (DISC_MODULES, GEN_MODULES, Batch,
                                          PhaseTimes)

    ws = root / "build" / "train_smoke"
    t0 = time.perf_counter()
    cfg_path = train_workspace(ws, root / "configs" / "config_example.yaml")
    cfg = load_config(str(cfg_path))
    mods = build_model(cfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(0))
    W.split_weight_norm(mods)
    save_checkpoint(str(ws / "seed.ckpt"), mods)
    seed_net = {k: W.module_tree(m) for k, m in mods.items()}
    n_params = sum(p.numel() for p in mods.parameters())
    del mods
    print(f"[7 train] workspace: {len(TRAIN_BINS)} bins, seed checkpoint "
          f"({n_params} parameters) in {time.perf_counter() - t0:.1f} s",
          flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LC.reset()
    trainer, wall = timed(lambda: train_loop.main(["-p", str(cfg_path)]))
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist, evals = trainer.history, trainer.evals
    n_steps = len(hist)
    print(f"[7 train] train_loop.main: {n_steps} steps (bins "
          f"{[h['bin'] for h in hist]}), {len(evals)} eval batches in "
          f"{wall:.1f} s; launches {counts}; peak allocated {peak:.2f} GiB "
          f"| {card}", flush=True)
    chk.check(3 <= n_steps <= 5 and len(evals) >= 1,
              f"train: {n_steps} steps, {len(evals)} evals")
    chk.check(counts["b2"] == B2_PER_STEP * n_steps + B2_PER_EVAL * len(evals)
              and counts["b1"] == 0, f"train launches {counts}")
    finite = all(np.isfinite(v) for h in hist for v in h["metrics"].values())
    finite = finite and all(np.isfinite(v) for e in evals for v in e.values())
    chk.check(finite, "train: every D and G loss finite")
    for i, h in enumerate(hist):
        print(f"[7 train] step {i}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in h["metrics"].items()), flush=True)
    moved = moved_modules(seed_net, trainer.modules)
    chk.check(all(moved[k] for k in GEN_MODULES + DISC_MODULES),
              f"train: every trainable module moved {moved}")
    chk.check(not moved["pitch_extractor"],
              "train: pitch_extractor bit-identical")

    host_ms = float(np.median([h["step_ms"] for h in hist[1:]]))
    print(f"[7 train] main run (no phase syncs): host wall per step call, "
          f"median of steps 1-{n_steps - 1}: {host_ms:.1f} ms; first step "
          f"{hist[0]['step_ms']:.1f} ms; peak allocated {peak:.2f} GiB "
          f"| {card}", flush=True)

    # one more step of the first bin: its launches and the plain formula's
    # calls (the backward's recomputes only), then one profiled step
    sampler = trainer.train_loader.sampler
    bin_id = sorted(sampler.time_bins)[0]
    idx = sampler.time_bins[bin_id][:cfg.batch_size]
    batch = Batch.from_numpy(collate(trainer.train_loader.dataset, idx,
                                     bin_id), "cuda")
    step = trainer.train_step_for(bin_id)
    gen = torch.Generator(device="cuda").manual_seed(2)
    plain = MK.log_mel_plain
    n_plain = [0]

    def counted_plain(*a, **k):
        n_plain[0] += 1
        return plain(*a, **k)

    MK.log_mel_plain = counted_plain
    LC.reset()
    try:
        step(trainer.modules, batch, gen)
        torch.cuda.synchronize()
    finally:
        MK.log_mel_plain = plain
    one = dict(launches(), plain=n_plain[0])
    chk.check(one == dict(b1=0, b2=B2_PER_STEP, plain=3),
              f"one step: {one} (want B2 {B2_PER_STEP}, B1 0, the plain "
              "formula only in the 3 MRSTFT backward recomputes)")
    print(f"[7 train] one step of bin {bin_id}: B2 {one['b2']} launches, "
          f"B1 {one['b1']}, log_mel_plain {one['plain']} calls (the MRSTFT "
          f"backward)", flush=True)

    # the step on this batch without and with the phase syncs (a
    # train.PhaseTimes; train_loop passes none), alternated: synchronised
    # before and after each run of STEPS_TIMED steps only, or also at each
    # phase mark
    def run_steps(phases: bool):
        recs = [PhaseTimes("cuda") if phases else None
                for _ in range(STEPS_TIMED)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for rec in recs:
            step(trainer.modules, batch, gen, times=rec)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / STEPS_TIMED, recs

    free, synced, split = [], [], []
    for _ in range(2):
        free.append(run_steps(False)[0])
        ms, recs = run_steps(True)
        synced.append(ms)
        split += [r.ms for r in recs]

    def med(key):
        return float(np.median([key(r) for r in split]))

    times = dict(
        step_ms=float(np.median(free)), step_phase_synced_ms=float(
            np.median(synced)), free_runs_ms=free, synced_runs_ms=synced,
        d_step_ms=med(lambda r: r["d_grads"] + r["d_opt"]),
        g_step_ms=med(lambda r: r["g_grads"] + r["g_opt"]),
        optimizer_ms=med(lambda r: r["d_opt"] + r["g_opt"]),
        main_run_host_ms=host_ms, first_step_ms=hist[0]["step_ms"],
        peak_gib=peak)
    print(f"[7 train] step of bin {bin_id}, {STEPS_TIMED} steps per run, "
          f"runs alternated: without phase syncs {free[0]:.1f}, "
          f"{free[1]:.1f} ms per step; with them {synced[0]:.1f}, "
          f"{synced[1]:.1f} ms = D step {times['d_step_ms']:.1f} + G step "
          f"{times['g_step_ms']:.1f} (optimizer {times['optimizer_ms']:.1f} "
          f"of them; medians) | {card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, pwall = timed(lambda: step(trainer.modules, batch, gen))
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.device_time_total)[:8]
    prof_out = dict(wall_ms=pwall * 1e3, busy_ms=busy,
                    idle=1.0 - busy / (pwall * 1e3),
                    events=sum(e.count for e in events),
                    top=[(e.key[:80], e.device_time_total / 1e3, e.count)
                         for e in top])
    print(f"[7 train] profiled step: wall {pwall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, idle {100 * prof_out['idle']:.1f}%, "
          f"{prof_out['events']} device events | {card}", flush=True)
    for key, ms, n in prof_out["top"]:
        print(f"[7 train]   {ms:9.3f} ms {n:6d} x {key}", flush=True)

    shapes = phase_train_b2(chk, trainer, card)
    parity = phase_train_parity(chk)

    from styletts2_tpu_torch.infer import StyleTTS2

    ckpt = Path(cfg.log_dir) / "epoch_00000.ckpt"
    engine = StyleTTS2(str(cfg_path), models_path=str(ckpt))
    ref_s = engine.compute_style(
        (0.1 * np.random.default_rng(4).standard_normal(24000 * 3))
        .astype(np.float32))
    wav = engine.generate(TEXTS["short"], {"style": ref_s, "speed": 1.0})
    ok = wav.size > 8000 and bool(np.isfinite(wav).all())
    chk.check(ok, "the trained checkpoint through the inference engine")
    print(f"[7 train] {ckpt.name} in the inference engine: generate "
          f"{len(wav)} samples, finite {bool(np.isfinite(wav).all())}",
          flush=True)
    return counts, dict(steps=n_steps, evals=len(evals), wall_s=wall,
                        times=times, profile=prof_out, b2_shapes=shapes,
                        cuda_vs_cpu=parity,
                        losses=[h["metrics"] for h in hist]), (
        cfg_path, batch, bin_id)


def phase_train_b2(chk: Checks, trainer, card: str):
    """B2 at every shape the training run gave it: compute_mels per bin
    and the three MRSTFT resolutions on the crops, forward against the
    plain version (eager ms, device ms, plain ms, bound), and the gradient
    through its autograd.Function against autograd of the plain formula on
    a random cotangent at the MRSTFT shapes (the same backward formula)."""
    import torch

    from styletts2_tpu_torch.data.loader import (bin_crop_frames,
                                                 bin_upper_frames)
    from styletts2_tpu_torch.losses import MRSTFT_RESOLUTIONS
    from styletts2_tpu_torch.ops import mel_kernel as MK

    cfg = trainer.cfg
    sp = cfg.preprocess_params.spect_params
    b = cfg.batch_size
    bins = sorted({h["bin"] for h in trainer.history})
    cases = [(f"mels bin {k}", bin_upper_frames(k) * sp.hop_length,
              sp.n_fft, sp.hop_length, sp.win_length, cfg.model_params.n_mels,
              False) for k in bins]
    crop = bin_crop_frames(bins[0], cfg.max_len) * 2 * sp.hop_length
    cases += [(f"mrstft {fft}", crop, fft, hop, win, 128, True)
              for fft, hop, win in MRSTFT_RESOLUTIONS]
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, t, n_fft, hop, win, m, grad in cases:
        wave = torch.randn(b, t, generator=gen, device="cuda") * 0.3
        kw = dict(n_fft=n_fft, hop_length=hop, win_length=win, n_mels=m)
        got = MK.log_mel(wave, **kw)
        want = MK.log_mel_plain(wave, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        chk.check(bool(torch.allclose(got, want, atol=2e-5, rtol=1e-4)),
                  f"B2 {name} B={b}: err {err:.3g}")
        ems = cuda_ms(lambda: MK.log_mel(wave, **kw), 10)
        dms = graph_ms(lambda: MK.log_mel(wave, **kw), 10)
        pms = cuda_ms(lambda: MK.log_mel_plain(wave, **kw), 5)
        n = b * got.shape[2]
        bms, by = b2_bound(b, t, got.shape[2], n_fft, win, m)
        row = dict(shape=[b, t], n_fft=n_fft, n_mels=m, frames=n,
                   max_abs_err=err, ms=ems, device_ms=dms, plain_ms=pms,
                   bound_ms=bms, bound_by=by)
        line = ""
        if grad:
            w1 = wave.clone().requires_grad_()
            y1 = MK.log_mel(w1, **kw)
            cot = torch.randn(y1.shape, generator=gen, device="cuda")
            g1, = torch.autograd.grad(y1, w1, cot)
            w2 = wave.clone().requires_grad_()
            g2, = torch.autograd.grad(MK.log_mel_plain(w2, **kw), w2, cot)
            rel = ((g1 - g2).norm() / g2.norm()).item()
            chk.check(rel < 1e-5, f"B2 {name} gradient rel-l2 {rel:.3g}")
            row["grad_rel_l2"] = rel
            line = f"; gradient rel-l2 {rel:.3g} (bound 1e-5)"
        out[name] = row
        print(f"[7 B2] {name} ({b}x{t}, n_fft {n_fft}, {m} mels, {n} "
              f"frames): max abs err {err:.3g}; kernel {ems:.3f} ms eager, "
              f"{dms:.3f} ms device; plain {pms:.3f} ms; bound {bms:.4f} ms "
              f"({by}){line} | {card}", flush=True)
    return out


def phase_train_parity(chk: Checks, devices=("cuda", "cpu"), decoder=None,
                       tag="[7 train]"):
    """One D/G step's losses and gradients on CUDA against the CPU at the
    small config (its decoder block replaced by `decoder` when given),
    same weights, draws fixed (coin soft, crops, the source's when the
    generator has one), dropout off; the CUDA step once more with cuDNN
    off; and (default decoder only) one BiLSTM's output with and without
    cuDNN against the CPU. With another decoder the step with cuDNN is
    reported and the one without it gated. cuDNN's LSTM rounds
    its f32 gates differently from the CPU (and from PyTorch's own CUDA
    kernels); the waveform losses' L1 terms and the TPRLS median selection
    turn such forward differences into larger gradient differences, most
    in the aligner (the soft-attention path). Gates: losses rel <
    TRAIN_LOSS_REL; CUDA without cuDNN vs the CPU < TRAIN_GRAD_REL per
    module; CUDA vs the CPU < TRAIN_GRAD_BOUND per module."""
    import copy
    import types

    import torch

    from styletts2_tpu_torch import train as TT
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.models import build_model

    raw = copy.deepcopy(TRAIN_TINY)
    if decoder is not None:
        raw["model_params"]["decoder"] = dict(decoder)
    cfg = load_config(raw)
    mods = build_model(cfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(3))
    W.split_weight_norm(mods)
    mods.train()
    mods["pitch_extractor"].eval()
    rng = np.random.default_rng(3)
    b, t_text, t_mel, crop = 2, 12, 100, 33
    hop = cfg.preprocess_params.spect_params.hop_length
    nb = types.SimpleNamespace(
        waves=(rng.standard_normal((b, t_mel * hop)) * 0.1).astype(np.float32),
        texts=rng.integers(4, 170, (b, t_text)),
        input_lengths=np.array([t_text, t_text - 3]),
        mel_lengths=np.array([t_mel, t_mel - 10]))
    starts = np.array([5, 2])
    rand_ini = rng.random((b, 9)).astype(np.float32)
    rand_ini[:, 0] = 0.0
    spf = mods["decoder"].generator.source_samples_per_frame
    noise = rng.standard_normal((b, 2 * crop * spf, 9)).astype(np.float32)

    def step(dev, cudnn=True):
        m = copy.deepcopy(mods).to(dev)
        batch = TT.Batch.from_numpy(nb, dev)
        source = ((torch.tensor(rand_ini, device=dev),
                   torch.tensor(noise, device=dev)) if spf else None)
        draws = TT.Draws(coin=True, starts=torch.tensor(starts, device=dev),
                         source=source, dropout=False)
        d_fn, g_fn = TT.make_grad_fns(cfg, crop)
        # flags() sets every cuDNN flag it is given and defaults TF32 on
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            d_loss, d_g = d_fn(m, batch, None, draws)
            met, g_g = g_fn(m, batch, None, draws)
        met["d_loss"] = d_loss
        grads = {k: torch.cat([g.flatten() for g in v]).cpu()
                 for k, v in {**d_g, **g_g}.items()}
        return {k: float(v) for k, v in met.items()}, grads

    dev, ref = devices
    (mc, gc), (_, gn), (mp, gp) = step(dev), step(dev, False), step(ref)

    def rel(x, y):
        return {k: float((x[k] - y[k]).norm() / y[k].norm()) for k in y}

    loss_rel = {k: abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp}
    grad_rel, no_cudnn, cudnn_spread = rel(gc, gp), rel(gn, gp), rel(gc, gn)
    bound = {k: TRAIN_GRAD_BOUND.get(k, TRAIN_GRAD_REL) for k in gp}
    what = f"{cfg.model_params.decoder.type} train step CUDA"
    chk.check(max(loss_rel.values()) < TRAIN_LOSS_REL,
              f"{what} vs CPU losses rel {loss_rel}")
    chk.check(max(no_cudnn.values()) < TRAIN_GRAD_REL,
              f"{what} without cuDNN vs CPU, gradients rel-l2 {no_cudnn}")
    if decoder is None:
        chk.check(all(grad_rel[k] < bound[k] for k in gp),
                  f"{what} vs CPU gradients rel-l2 {grad_rel}")

    def fmt(d):
        return ", ".join(f"{k} {v:.2e}" for k, v in d.items())

    lstm_rel, lstm_line = {}, ""
    if decoder is None:
        lstm = torch.nn.LSTM(96, 32, batch_first=True, bidirectional=True)
        x = torch.from_numpy(rng.standard_normal((4, 33, 96)).astype(
            np.float32))
        with torch.no_grad():
            want = lstm(x)[0]
            for name, on in (("cudnn", True), ("native", False)):
                with torch.backends.cudnn.flags(enabled=on, allow_tf32=False):
                    got = copy.deepcopy(lstm).to(dev)(x.to(dev))[0].cpu()
                lstm_rel[name] = float((got - want).norm() / want.norm())
        lstm_line = (f"; one BiLSTM's output vs the CPU: cuDNN "
                     f"{lstm_rel['cudnn']:.2e}, without cuDNN "
                     f"{lstm_rel['native']:.2e}")

    print(f"{tag} one D/G step CUDA vs CPU (small {cfg.model_params.decoder.type}"
          f" config, draws fixed): losses rel {fmt(loss_rel)} (bound "
          f"{TRAIN_LOSS_REL:g})", flush=True)
    print(f"{tag}   gradients rel-l2 CUDA vs CPU: {fmt(grad_rel)} "
          + (f"(bounds {fmt(bound)})" if decoder is None else
             "(reported: the gate is the step without cuDNN)"), flush=True)
    print(f"{tag}   CUDA without cuDNN vs CPU: {fmt(no_cudnn)} (bound "
          f"{TRAIN_GRAD_REL:g}); CUDA with vs without cuDNN: "
          f"{fmt(cudnn_spread)}{lstm_line}", flush=True)
    return dict(loss_rel=loss_rel, grad_rel=grad_rel, grad_bound=bound,
                no_cudnn=no_cudnn, cudnn_spread=cudnn_spread,
                lstm_rel=lstm_rel)


# phase 8: the other decoder types. The small decoder of each type for the
# CUDA-vs-CPU step, as tests/test_torch_istftnet.py and test_torch_vocos.py
# build them (prod(rates) * iSTFT hop, and Vocos's iSTFT hop, equal the
# small config's mel hop of 60)
DECODER_TYPES = ("istftnet", "vocos")
TINY_DECODERS = {
    "istftnet": {"type": "istftnet", "upsample_initial_channel": 512,
                 "upsample_rates": [2, 6], "upsample_kernel_sizes": [4, 12],
                 "resblock_kernel_sizes": [3],
                 "resblock_dilation_sizes": [[1]],
                 "gen_istft_n_fft": 20, "gen_istft_hop_size": 5},
    "vocos": {"type": "vocos", "intermediate_dim": 128, "num_layers": 2,
              "gen_istft_n_fft": 240, "gen_istft_hop_size": 60},
}


def phase_decoder(chk: Checks, root: Path, card: str, dec_type: str,
                  workload, windows):
    """One decoder type at full width (config_example.yaml's widths, bf16
    decoder, seeded random weights): warmup; compute_style and generate on
    the short text through a replayed fused graph (a counted window);
    phase_fused's fused-graph vs two-phase comparison; generate_batch on
    the eight texts, each row gated at twice what one phase-2 call moves
    at another batch or bucket for this decoder (phase2_spread); for
    iSTFTNet, B1 against its plain version at its stages' shapes and every
    launch of one phase-2 call timed; the f32 CUDA engine against the f32
    CPU engine; one full-width D/G step on phase 7's batch and the small
    config's CUDA-vs-CPU step. Adds its windows to `windows`."""
    import torch
    import yaml

    from styletts2_tpu_torch.config import load_config, with_decoder_type
    from styletts2_tpu_torch.infer import StyleTTS2

    tag = f"[8 {dec_type}]"
    cfg = load_config(with_decoder_type(yaml.safe_load(
        (root / "configs" / "config_example.yaml").read_text()), dec_type))
    dec = cfg.model_params.decoder
    per_eval = b1_per_eval(dec)
    out = {}
    t0 = time.perf_counter()
    engine = StyleTTS2(cfg, seed=0)
    gen_params = sum(p.numel() for p in
                     engine.modules["decoder"].generator.parameters())
    print(f"{tag} init {time.perf_counter() - t0:.1f} s, {dec}, decoder "
          f"{engine.dtype}, generator {gen_params} parameters, {per_eval} B1 "
          f"launches per phase-2 evaluation", flush=True)
    clip = style_clip(engine.sr)
    style = {"style": engine.compute_style(clip), "speed": 1.0}
    _, wall = timed(lambda: engine.warmup(token_buckets=(64,),
                                          frame_buckets=(904,)))
    print(f"{tag} warmup (token bucket 64, frame bucket 904): {wall:.1f} s, "
          f"fused graphs at {sorted(engine.graphs)}", flush=True)
    chk.check(len(engine.graphs) >= 1, f"{tag} warmup captured graphs")
    for _ in range(2):
        engine.generate(TEXTS["short"], style)
    torch.cuda.synchronize()

    win = Launches(engine)
    ref_s = engine.compute_style(clip)
    style = {"style": ref_s, "speed": 1.0}
    wav, wall = timed(lambda: engine.generate(TEXTS["short"], style))
    c = win.read()
    windows[f"{dec_type} generate"] = c
    secs = len(wav) / engine.sr
    audible = float(np.abs(wav[4000:-4000]).max()) if len(wav) > 8000 else 0.0
    chk.check(bool(np.isfinite(wav).all()) and len(wav) > 8000
              and audible > 0 and np.abs(wav).max() <= 1.0
              and np.abs(wav[:4000]).max() == 0, f"{tag} generate short")
    check_b1_counts(chk, c, f"{tag} generate", per_eval)
    chk.check(c["replays"] >= 1 and c["b2"] >= 1,
              f"{tag} a fused graph replayed, B2 launched: {c}")
    chk.check(all(g.launches.get("ada_snake_conv", 0) == per_eval
                  for g in engine.graphs.values()),
              f"{tag} every fused graph recorded {per_eval} B1 launches")
    print(f"{tag} compute_style + generate short: {len(wav)} samples "
          f"({secs:.2f} s audio), peak {audible:.3f}, wall {wall * 1e3:.1f} "
          f"ms, 1/RTF {secs / wall:.1f}; launches {c} | {card}", flush=True)
    out["fused"] = phase_fused(chk, engine, style, card, tag)

    engine.duration_scale = DURATION_SCALE
    texts = BATCH_TEXTS
    engine.generate_batch(texts, style, stabilize=False)  # warm-up
    spread = phase2_spread(engine, texts[0], style)
    bound = 2.0 * max(spread["batch8"], spread["next_bucket"])
    win = Launches(engine)
    outs, wall = timed(lambda: engine.generate_batch(texts, style,
                                                     stabilize=False))
    c = win.read()
    windows[f"{dec_type} generate_batch"] = c
    check_b1_counts(chk, c, f"{tag} generate_batch", per_eval)
    rel = []
    for text, got in zip(texts, outs):
        want = engine.generate(text, style, stabilize=False)
        ok = got.shape == want.shape and np.isfinite(got).all()
        rel.append(rel_l2(got, want) if ok else 1.0)
    chk.check(max(rel) <= bound, f"{tag} bf16 generate_batch vs generate "
              f"rel-l2 {rel} (bound {bound:.3g})")
    secs = sum(len(w) for w in outs) / engine.sr
    print(f"{tag} generate_batch {len(texts)} texts: {secs:.2f} s audio in "
          f"{wall * 1e3:.1f} ms (1/RTF {secs / wall:.1f}), "
          f"{c['phase2_calls']} phase-2 calls; each text vs its own "
          f"generate rel-l2 {', '.join(f'{r:.3g}' for r in rel)} (bound "
          f"{bound:.3g} = twice the larger spread); {spread_line(spread)} "
          f"| {card}", flush=True)
    engine.duration_scale = None
    out["batch"] = dict(rel_l2=rel, bound=bound, spread=spread,
                        inv_rtf=secs / wall)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if dec_type == "istftnet":
        # the same spread with the generator in f32 (is it bf16's?)
        engine = StyleTTS2(cfg, seed=0, decoder_dtype="float32")
        engine.duration_scale = DURATION_SCALE
        sp32 = phase2_spread(engine, texts[0], style, probes=False)
        out["batch"]["spread_f32"] = sp32
        print(f"{tag} f32 generator, one text's phase 2 on identical inputs "
              f"({sp32['frames']} frames, bucket {sp32['frame_bucket']}): "
              f"next bucket rel-l2 {sp32['next_bucket']:.3g}, batch 8 "
              f"{sp32['batch8']:.3g} (bf16: {spread['next_bucket']:.3g}, "
              f"{spread['batch8']:.3g}) | {card}", flush=True)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    if dec_type == "istftnet":
        out["b1"] = phase_b1_decoder(chk, cfg, 256, tag)
    out["f32"] = phase_decoder_f32(chk, cfg, tag)
    out["train"] = phase_decoder_train(chk, dec_type, workload, tag, card)
    windows[f"{dec_type} train"] = out["train"]["launches_all"]
    out["train_parity"] = phase_train_parity(
        chk, decoder=TINY_DECODERS[dec_type], tag=tag)
    return out


def phase_b1_decoder(chk: Checks, cfg, frame_bucket: int, tag: str):
    """B1 against its plain version at every (C, T, k, d) of the decoder's
    stages at `frame_bucket` (iSTFTNet: C 256 at T = 20F, C 128 at the odd
    T = 120F + 1), f32 and bf16, each with its valid prefix ending before
    T and at T itself, with and without the residual and stats epilogues;
    then every launch of one bf16 phase-2 call timed (b1_times)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    stages = b1_stages(cfg.model_params.decoder, frame_bucket)
    compare = B1Compare(chk, gen)
    t0 = time.perf_counter()
    for c, t, blocks in stages:
        for k in sorted({k for k, _ in blocks}):
            for d in sorted({d for _, dl in blocks for d in dl}):
                for dtype, res, st, full in (
                        (torch.float32, False, False, False),
                        (torch.bfloat16, True, True, False),
                        (torch.float32, True, True, True),
                        (torch.bfloat16, False, True, True)):
                    compare(c, t, k, d, dtype, res, st, tag=f" {tag}",
                            full=full)
    print(f"{tag} B1 at {[(c, t) for c, t, _ in stages]}: {compare.n} checks "
          f"in {time.perf_counter() - t0:.1f} s, max abs err "
          f"{compare.max_err:.4g}", flush=True)
    return dict(max_abs_err=compare.max_err, checks=compare.n,
                **b1_times(stages, gen, f"{tag} B1 time",
                           f"one bf16 phase-2 call at frame bucket "
                           f"{frame_bucket}"))


def phase_decoder_f32(chk: Checks, cfg, tag: str):
    """The f32 engine on CUDA against the same engine on the CPU, one chunk
    (phase 6's first comparison). iSTFTNet also runs with the CPU run's
    source STFT fed to the CUDA run (both two-phase): the source's phase
    is branch-cut ambiguous at quiet bins and near +-pi, where the two
    devices' f32 sine and DFT roundings can take either sign, so the
    gated comparison shares it and the unshared one is reported."""
    import copy

    import torch
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.nn.istftnet import ISTFTNetGenerator

    text = "Hello there"
    s = np.random.default_rng(3).standard_normal((1, 128)).astype(
        np.float32) * 0.3
    istft = cfg.model_params.decoder.type == "istftnet"
    features = ISTFTNetGenerator.source_features
    recorded = []
    out = {}
    for dev in ("cpu", "cuda"):
        engine = StyleTTS2(copy.deepcopy(cfg), seed=3,
                           decoder_dtype="float32", device=dev)
        n_tok = len(engine.cleaner(text)) + 2
        engine.fixed_duration = cfg.tpu.frame_buckets[0] // n_tok
        t0 = time.perf_counter()
        out[dev] = engine.generate(text, {"style": s}, stabilize=False)
        if istft:
            engine.fused_enabled = False

            def shared(self, f0, source=None, dev=dev):
                if dev == "cpu":
                    recorded.append(features(self, f0, source))
                    return recorded[-1]
                return recorded[0].to(f0.device)

            ISTFTNetGenerator.source_features = shared
            try:
                out[dev + " shared"] = engine.generate(text, {"style": s},
                                                       stabilize=False)
            finally:
                ISTFTNetGenerator.source_features = features
        print(f"{tag} f32 {dev}: {len(out[dev])} samples in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del engine
    rel = rel_l2(out["cuda"], out["cpu"])
    res = dict(rel_l2=rel)
    if istft:
        res["rel_l2_shared_source"] = shared_rel = rel_l2(out["cuda shared"],
                                                          out["cpu shared"])
        gated = shared_rel
        line = (f"with the CPU's source STFT shared {shared_rel:.3g} (gated), "
                f"unshared {rel:.3g}")
    else:
        gated, line = rel, f"{rel:.3g}"
    chk.check(out["cuda"].shape == out["cpu"].shape and gated < F32_CPU_BOUND
              and np.abs(out["cpu"]).max() > 0,
              f"{tag} f32 CUDA vs CPU rel-l2 {res}")
    print(f"{tag} f32 CUDA vs CPU engine, frame bucket "
          f"{cfg.tpu.frame_buckets[0]}: generate rel-l2 {line} (bound "
          f"{F32_CPU_BOUND:g})", flush=True)
    torch.cuda.empty_cache()
    return res


def phase_decoder_train(chk: Checks, dec_type: str, workload, tag: str,
                        card: str):
    """One full-width D/G step of this decoder type on phase 7's batch
    (its config with the decoder type changed: batch 5, its bin's crop,
    f32, TF32 off), seeded random weights: the launches of one step (8 B2,
    no B1), finite losses, every trained module moved; then runs of
    STEPS_TIMED steps synchronised at their ends (ms per step) and the
    peak memory allocated."""
    import torch
    import yaml

    from styletts2_tpu_torch import train as TT
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.config import load_config, with_decoder_type
    from styletts2_tpu_torch.data.loader import bin_crop_frames
    from styletts2_tpu_torch.models import build_model
    from styletts2_tpu_torch.ops import launch_count as LC
    from styletts2_tpu_torch.optim import MultiOptimizer

    cfg_path, batch, bin_id = workload
    cfg = load_config(with_decoder_type(yaml.safe_load(cfg_path.read_text()),
                                        dec_type))
    mods = build_model(cfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(0))
    W.split_weight_norm(mods)
    mods.to("cuda").train()
    mods["pitch_extractor"].eval().requires_grad_(False)
    step = TT.make_train_step(cfg, MultiOptimizer(mods), crop_frames=
                              bin_crop_frames(bin_id, cfg.max_len))
    gen = torch.Generator(device="cuda").manual_seed(2)
    before = {k: [p.detach().clone() for p in mods[k].parameters()]
              for k in TT.GEN_MODULES + TT.DISC_MODULES}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LC.reset()
    metrics, first = timed(lambda: step(mods, batch, gen))
    counts = launches()
    metrics = {k: float(v) for k, v in metrics.items()}
    moved = {k: any(not torch.equal(a, p) for a, p in
                    zip(before[k], mods[k].parameters())) for k in before}
    del before
    chk.check(counts == dict(b1=0, b2=B2_PER_STEP),
              f"{tag} one step's launches {counts}")
    chk.check(all(np.isfinite(v) for v in metrics.values()),
              f"{tag} train losses finite {metrics}")
    chk.check(all(moved.values()), f"{tag} every trained module moved "
              f"{moved}")
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(STEPS_TIMED):
            step(mods, batch, gen)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3 / STEPS_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = 1 + 2 * STEPS_TIMED
    launches_all = launches()
    chk.check(launches_all == dict(b1=0, b2=B2_PER_STEP * n_steps),
              f"{tag} {n_steps} steps' launches {launches_all}")
    print(f"{tag} full-width D/G step (batch {batch.waves.shape[0]}, bin "
          f"{bin_id}, f32): first {first * 1e3:.1f} ms, then runs of "
          f"{STEPS_TIMED}: {runs[0]:.1f}, {runs[1]:.1f} ms per step; peak "
          f"allocated {peak:.2f} GiB; one step's launches {counts}; losses "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
          + f" | {card}", flush=True)
    del mods, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_ms=float(np.median(runs)), runs_ms=runs,
                first_step_ms=first * 1e3, peak_gib=peak, launches=counts,
                launches_all=launches_all, losses=metrics)


def quantised(x: np.ndarray) -> np.ndarray:
    """x moved to half a 16-bit step off an integer, so that write_wav (x *
    32767 truncated in f32) and write_flac (in f64) store the same
    samples."""
    q = np.round(np.clip(x, -0.999, 0.999) * 32767.0)
    return ((q + 0.5 * np.sign(q)) / 32767.0).astype(np.float32)


def wav_pcm(data: bytes) -> np.ndarray:
    """The int16 samples of a mono 16-bit WAV in memory."""
    import io
    import wave

    with wave.open(io.BytesIO(data)) as f:
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def http(url: str, body=None):
    """(wall seconds, response bytes) of a GET, or of a POST of JSON."""
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        data = r.read()
    return time.perf_counter() - t0, data


def phase_deploy(chk: Checks, root: Path, card: str, train_cfg: Path,
                 windows):
    """The deployment path at full width (config_example.yaml, bf16
    decoder, seeded random weights): reference-layout .pth files written by
    the port (all eight modules; a Vocos config's four inference modules
    with new-style weight-norm keys), each loaded by StyleTTS2(cfg, path)
    and held bit for bit against the engine built from the same tree; one
    train_loop D/G step with the .pth as pretrained_model; a voices
    directory of the style clip as WAV and as FLAC (equal styles, B2
    counted); then serve_http on 127.0.0.1 with async capture: a cold /tts
    answered two-phase while the worker captures the pair's graph, a
    request during the capture, the graph's B1 count, the same request
    through the graph, and /tts_batch against generate_batch."""
    import base64
    import copy
    import threading

    import torch
    import yaml

    from styletts2_tpu_torch import audio as AUD
    from styletts2_tpu_torch import train_loop
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.config import load_config, with_decoder_type
    from styletts2_tpu_torch.convert import save_torch_checkpoint
    from styletts2_tpu_torch.flac import write_flac
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.models import (INFERENCE_MODULES,
                                            build_inference_modules,
                                            build_model)
    from styletts2_tpu_torch.ops import launch_count as LC
    from styletts2_tpu_torch.tools.serve_http import (TTSService,
                                                      make_server, wav_bytes)

    tag = "[9 deploy]"
    ws = root / "build" / "deploy_smoke"
    shutil.rmtree(ws, ignore_errors=True)
    (ws / "voices").mkdir(parents=True)
    raw = yaml.safe_load((root / "configs" / "config_example.yaml")
                         .read_text())
    out = {}

    def tree_of(mods, seed):
        W.init_random(mods, torch.Generator().manual_seed(seed))
        W.split_weight_norm(mods)
        return {k: W.module_tree(m) for k, m in mods.items()}

    cfgs = {"hifigan": load_config(copy.deepcopy(raw)),
            "vocos": load_config(with_decoder_type(copy.deepcopy(raw),
                                                   "vocos"))}
    t0 = time.perf_counter()
    nets = {"hifigan": tree_of(build_model(cfgs["hifigan"].model_params), 5),
            "vocos": tree_of(build_inference_modules(
                cfgs["vocos"].model_params), 6)}
    paths = {k: ws / f"{k}.pth" for k in nets}
    for k, net in nets.items():
        save_torch_checkpoint(net, str(paths[k]), new_style_modules=(
            ("decoder",) if k == "vocos" else ()))
    sizes = {k: p.stat().st_size / 2 ** 20 for k, p in paths.items()}
    keys = torch.load(str(paths["vocos"]), map_location="cpu",
                      weights_only=False)["net"]["decoder"]
    chk.check(any(".parametrizations.weight.original1" in k for k in keys),
              f"{tag} the Vocos .pth has new-style weight-norm keys")
    print(f"{tag} wrote reference-layout .pth files: hifigan (8 modules) "
          f"{sizes['hifigan']:.1f} MiB, vocos (4 modules, new-style weight "
          f"norm) {sizes['vocos']:.1f} MiB in {time.perf_counter() - t0:.1f}"
          f" s", flush=True)

    # the engine built from each .pth against the one built from its tree
    text = TEXTS["medium"]
    clip = quantised(style_clip(24000))
    engines = {}
    for k in ("vocos", "hifigan"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        from_pth = StyleTTS2(cfgs[k], str(paths[k]), seed=0)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        from_tree = StyleTTS2(cfgs[k], params={m: nets[k][m] for m in
                                               INFERENCE_MODULES}, seed=0)
        style = {"style": from_pth.compute_style(clip), "speed": 1.0}
        wavs = []
        for e in (from_pth, from_tree):
            e._rng = np.random.default_rng(7)
            wavs.append(e.generate(text, style))
        same = (np.array_equal(wavs[0], wavs[1])
                and from_pth.graph_replays == from_tree.graph_replays == 1)
        chk.check(same and len(wavs[0]) > 8000,
                  f"{tag} {k}: StyleTTS2(cfg, .pth) == StyleTTS2(cfg, "
                  f"params=tree) through a fused graph")
        print(f"{tag} {k}: StyleTTS2(cfg, .pth) init {load_ms:.1f} ms; "
              f"fused generate of the medium text ({len(wavs[0])} samples, "
              f"a graph replay each) equal to the tree-built engine's "
              f"{same} (rel-l2 {rel_l2(wavs[0], wavs[1]):.3g}) | {card}",
              flush=True)
        out[f"{k}_pth_init_ms"] = load_ms
        engines[k] = from_pth
        del from_tree
    del engines["vocos"], nets
    gc.collect()
    torch.cuda.empty_cache()

    # one train_loop D/G step with the .pth as pretrained_model: the first
    # duration bin's first batch of phase 7's workspace
    tcfg = yaml.safe_load(train_cfg.read_text())
    data = tcfg["data_params"]
    lines = [ln for ln in Path(data["train_data"]).read_text().splitlines(
        keepends=True) if "/b0_" in ln][: tcfg["batch_size"]]
    (ws / "one_batch.txt").write_text("".join(lines))
    tcfg.update(pretrained_model=str(paths["hifigan"]),
                load_only_params=True, epochs=1, save_freq=1000,
                log_dir=str(ws / "runs"),
                data_params=dict(data, train_data=str(ws / "one_batch.txt"),
                                 val_data=str(ws / "one_batch.txt")))
    (ws / "train.yaml").write_text(yaml.safe_dump(tcfg, allow_unicode=True))
    LC.reset()
    trainer, wall = timed(lambda: train_loop.main(["-p",
                                                   str(ws / "train.yaml")]))
    counts = launches()
    hist = trainer.history
    finite = all(np.isfinite(v) for h in hist for v in h["metrics"].values())
    chk.check(len(hist) == 1 and finite and counts == dict(
        b1=0, b2=B2_PER_STEP + B2_PER_EVAL * len(trainer.evals)),
        f"{tag} train_loop from the .pth: {len(hist)} steps, finite "
        f"{finite}, launches {counts}")
    windows["deploy train"] = counts
    print(f"{tag} train_loop.main with the .pth as pretrained_model: "
          f"{len(hist)} D/G step, {len(trainer.evals)} eval batch in "
          f"{wall:.1f} s, losses finite {finite}, launches {counts} | "
          f"{card}", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # the voices directory: the style clip as WAV and as FLAC
    engine = engines.pop("hifigan")
    per_eval = b1_per_eval(engine.cfg.model_params.decoder)
    AUD.write_wav(str(ws / "voices" / "wav_voice.wav"), clip)
    write_flac(str(ws / "voices" / "flac_voice.flac"), clip)
    win = Launches(engine)
    service = TTSService.build(engine, voices_dir=str(ws / "voices"))
    c = windows["deploy voices"] = win.read()
    same = np.array_equal(service.styles["wav_voice"],
                          service.styles["flac_voice"])
    chk.check(same and c["b2"] >= 2 and c["b1"] == 0,
              f"{tag} FLAC voice == WAV voice, B2 launched: {c}")
    print(f"{tag} voices dir (the 5-s clip as WAV and as FLAC): styles "
          f"equal {same}; launches {c}", flush=True)

    # serve_http with background capture
    engine.fused_compile = "async"
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        health = json.loads(http(base + "/health")[1])
        chk.check(health["ok"] and health["n_voices"] == 2,
                  f"{tag} /health {health}")
        req = {"text": TEXTS["short"], "voice": "wav_voice"}
        win = Launches(engine)
        graphs0 = set(engine.graphs)
        engine._rng = np.random.default_rng(7)
        cold_s, cold = http(base + "/tts", req)
        queued = set(engine._fused_pending) | (set(engine.graphs) - graphs0)
        engine._rng = np.random.default_rng(7)
        at_start = bool(engine._fused_pending)
        during_s, during = http(base + "/tts", req)
        still = bool(engine._fused_pending)
        engine.wait_fused_compiles()  # re-raises a failed capture
        new = set(engine.graphs) - graphs0
        c_cold = win.read()
        chk.check(len(new) == 1 and new == queued
                  and c_cold["replays"] == 0 and cold == during,
                  f"{tag} a cold /tts answered two-phase while its pair "
                  f"{sorted(queued)} was captured in the background "
                  f"(graphs new {sorted(new)}): {c_cold}")
        check_b1_counts(chk, c_cold, f"{tag} cold requests", per_eval)
        key = next(iter(new)) if len(new) == 1 else None
        g = engine.graphs.get(key)
        rec_b1 = g.launches.get("ada_snake_conv") if g else None
        chk.check(g is not None and g.background and rec_b1 == per_eval,
                  f"{tag} the background graph recorded {rec_b1} B1 "
                  f"launches (want {per_eval})")
        win = Launches(engine)
        warm = []
        for _ in range(3):
            engine._rng = np.random.default_rng(7)
            warm.append(http(base + "/tts", req))
        c_warm = win.read()
        # the same request two-phase with no capture running: what the
        # cold and the during-capture requests cost beyond the path itself
        engine.fused_enabled = False
        engine._rng = np.random.default_rng(7)
        plain_s, plain = http(base + "/tts", req)
        engine.fused_enabled = True
        chk.check(plain == cold, f"{tag} the two-phase request repeats")
        windows["deploy serve"] = {k: c_cold[k] + c_warm[k] for k in c_cold}
        check_b1_counts(chk, c_warm, f"{tag} warm requests", per_eval)
        pcm = [wav_pcm(b) for b in (cold, warm[0][1])]
        chk.check(c_warm["replays"] == 3 and c_warm["phase2_calls"] == 0
                  and len(pcm[0]) == len(pcm[1])
                  and all(w[1] == warm[0][1] for w in warm),
                  f"{tag} the same request through the graph: "
                  f"{len(pcm[1])} samples vs two-phase {len(pcm[0])}, "
                  f"{c_warm}")
        warm_ms = float(np.median([w[0] for w in warm])) * 1e3
        secs = len(pcm[1]) / engine.sr
        print(f"{tag} /tts short text, voice from the WAV: cold (two-phase,"
              f" capture queued) {cold_s * 1e3:.1f} ms; during the capture "
              f"(still capturing at its end: {still}) {during_s * 1e3:.1f} "
              f"ms (capturing at its start: {at_start}); two-phase with no "
              f"capture running {plain_s * 1e3:.1f} ms; cold capture on "
              f"the worker (warm-up call + capture) "
              f"{g.capture_ms if g else float('nan'):.1f} ms; through the "
              f"graph {', '.join(f'{w[0] * 1e3:.1f}' for w in warm)} ms, "
              f"median {warm_ms:.1f} ms (1/RTF {secs / warm_ms * 1e3:.1f}); "
              f"graph recorded {rec_b1} B1 launches; samples two-phase "
              f"{len(pcm[0])} vs graph {len(pcm[1])}, rel-l2 "
              f"{rel_l2(pcm[1] * 1.0, pcm[0] * 1.0):.3g} | {card}",
              flush=True)

        engine.duration_scale = DURATION_SCALE
        style = {"style": service.styles["wav_voice"], "speed": 1.0}
        want = engine.generate_batch(BATCH_TEXTS, style, stabilize=False)
        win = Launches(engine)
        batch_s, body = http(base + "/tts_batch", {
            "texts": BATCH_TEXTS, "voice": "wav_voice", "stabilize": False})
        c = windows["deploy tts_batch"] = win.read()
        check_b1_counts(chk, c, f"{tag} /tts_batch", per_eval)
        got = [base64.b64decode(b) for b in json.loads(body)["wavs"]]
        same = (len(got) == len(want) and all(
            a == wav_bytes(w, engine.sr) for a, w in zip(got, want)))
        chk.check(same, f"{tag} /tts_batch == generate_batch, row by row")
        secs = sum(len(w) for w in want) / engine.sr
        print(f"{tag} /tts_batch {len(BATCH_TEXTS)} texts: {secs:.2f} s "
              f"audio in {batch_s * 1e3:.1f} ms, 1/RTF {secs / batch_s:.1f},"
              f" rows == generate_batch {same}; launches {c} | {card}",
              flush=True)
        engine.duration_scale = None
        out.update(cold_ms=cold_s * 1e3, during_capture_ms=during_s * 1e3,
                   two_phase_ms=plain_s * 1e3,
                   capturing_at_start=at_start, capturing_at_end=still,
                   capture_ms=g.capture_ms if g else None,
                   graph_b1=rec_b1, warm_ms=warm_ms,
                   warm_runs_ms=[w[0] * 1e3 for w in warm],
                   batch_ms=batch_s * 1e3, batch_inv_rtf=secs / batch_s)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.fused_compile = "sync"
    del engine, service
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 10: the SLM adversarial stage. WavLM on CUDA vs the CPU in f32
# (TF32 off): summation order only
WAVLM_REL = 1e-3
SLM_ITER = 2  # train_loop's SLM round after every 2nd step of an epoch


def seed_workspace(root: Path) -> Path:
    """Phase 7's workspace and seed checkpoint (seeded random weights),
    for a run that skips phase 7. Returns the config's path."""
    import torch

    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.checkpoint import save_checkpoint
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.models import build_model

    ws = root / "build" / "train_smoke"
    cfg_path = train_workspace(ws, root / "configs" / "config_example.yaml")
    mods = build_model(load_config(str(cfg_path)).model_params)
    W.init_random(mods, torch.Generator().manual_seed(0))
    W.split_weight_norm(mods)
    save_checkpoint(str(ws / "seed.ckpt"), mods)
    return cfg_path


def hf_layout(wavlm):
    """A WavLM's state dict as HF WavLMModel stores it: the positional
    conv's weight in the parametrized weight-norm keys (g = its norm over
    dims 0 and 1, v = the weight) and masked_spec_embed."""
    import torch

    sd = dict(wavlm.state_dict())
    w = sd.pop("encoder.pos_conv_embed.conv.weight")
    key = "encoder.pos_conv_embed.conv.parametrizations.weight."
    sd[key + "original0"] = torch.sqrt((w * w).sum(dim=(0, 1), keepdim=True))
    sd[key + "original1"] = w
    sd["masked_spec_embed"] = torch.zeros(w.shape[0])
    return sd


class SLMRounds:
    """Wraps SLMAdversarialTrainer.step while open: each round's ms of the
    generator and discriminator steps (a train.PhaseTimes), its kernel
    launches, and which modules it moved (the loop's modules, the head and
    WavLM)."""

    def __init__(self):
        from styletts2_tpu_torch.nn import slm as SLM

        self.cls, self.step, self.rounds = SLM.SLMAdversarialTrainer, None, []

    def __enter__(self):
        import torch

        from styletts2_tpu_torch.train import PhaseTimes

        self.step = step = self.cls.step
        rounds = self.rounds

        def recorded(trainer, mods, *a, **kw):
            now = {**mods, "wavlm_d": trainer.wl.wd,
                   "wavlm": trainer.wl.wavlm}
            snap = {k: [p.detach().clone() for p in m.parameters()]
                    for k, m in now.items()}
            before = launches()
            times = PhaseTimes(next(trainer.wl.wd.parameters()).device)
            out = step(trainer, mods, *a, times=times, **kw)
            counts = {k: v - before[k] for k, v in launches().items()}
            moved = {k for k, m in now.items() if any(
                not torch.equal(x, q)
                for x, q in zip(snap[k], m.parameters()))}
            grads = {k for k, m in now.items()
                     if any(q.grad is not None for q in m.parameters())}
            rounds.append(dict(ms=dict(times.ms), launches=counts,
                               moved=sorted(moved), grads=sorted(grads),
                               losses={k: float(v) for k, v in out.items()}))
            return out

        self.cls.step = recorded
        return self

    def __exit__(self, *exc):
        self.cls.step = self.step


def check_round(chk: Checks, r, what: str) -> None:
    """One round: B2 once (the style mel), B1 never, finite losses, moved
    predictor, decoder and the head only, no .grad left."""
    chk.check(r["launches"] == dict(b1=0, b2=1), f"{what} launches "
              f"{r['launches']} (want B2 1, B1 0)")
    chk.check(all(np.isfinite(v) for v in r["losses"].values()),
              f"{what} losses finite {r['losses']}")
    chk.check(r["moved"] == ["decoder", "predictor", "wavlm_d"],
              f"{what} moved {r['moved']} (want decoder, predictor, "
              "wavlm_d)")
    chk.check(not r["grads"], f"{what} left .grad on {r['grads']}")


def round_line(r) -> str:
    return (f"generator step {r['ms']['slm_g']:.1f} ms, discriminator step "
            f"{r['ms']['slm_d']:.1f} ms; launches {r['launches']}; slm_g "
            f"{r['losses']['slm_g']:.4g}, slm_d {r['losses']['slm_d']:.4g}; "
            f"moved {', '.join(r['moved'])}")


def slm_round_parts(cfg, mods, wavlm, wd, nb, crop, source, dev,
                    cudnn=True, at=None):
    """One SLM round of `mods` on `dev` (copies), split as
    tests/test_torch_slm.py splits it: the generator and discriminator
    steps' losses, the head's gradients and the end-to-end gradients of
    predictor and decoder; the decoder's inputs (asr, F0, N, style, frame
    mask) and the cotangents its loss sends back; then, at `at` (another
    run's result, or this run's when None), the decoder's gradients and
    input cotangents at that run's decoder inputs and the predictor's
    gradients pulled back along that run's cotangents. All on the CPU."""
    import copy

    import torch

    from styletts2_tpu_torch import losses as LO
    from styletts2_tpu_torch.nn import slm as SLM
    from styletts2_tpu_torch.optim import MultiOptimizer

    m = copy.deepcopy(mods).to(dev)
    tr = SLM.SLMAdversarialTrainer(cfg, MultiOptimizer(m), LO.WavLMLoss(
        copy.deepcopy(wavlm).to(dev), copy.deepcopy(wd).to(dev)))
    texts, lens, waves = (torch.as_tensor(a).to(dev) for a in
                          (nb.texts, nb.input_lengths, nb.waves))
    src = tuple(t.to(dev) for t in source)

    def flat(ts):
        return torch.cat([t.flatten() for t in ts]).cpu()

    out = {}
    with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
        seen, got = [], {}

        def keep(mod, args):
            seen.extend(args[:5])
            for i in range(3):
                args[i].register_hook(lambda g, i=i: got.__setitem__(i, g))

        hook = m["decoder"].register_forward_pre_hook(keep)
        g_loss, y, g = tr.generator_grads(m, texts, lens, waves, crop, src)
        hook.remove()
        d_loss, d = tr.discriminator_grads(waves, y, crop)
        out.update(losses=dict(slm_g=float(g_loss), slm_d=float(d_loss)),
                   wavlm_d=flat(d), end_to_end={k: flat(v) for k, v in
                                                g.items()},
                   dec_in=[t.detach().cpu() for t in seen],
                   cots=[got[i].cpu() for i in range(3)])
        at = at or out
        ins = [t.to(dev).requires_grad_(i < 3)
               for i, t in enumerate(at["dec_in"])]
        loss = tr.wl.generator(m["decoder"](*ins, src)[..., 0]) * tr.scale
        params = list(m["decoder"].parameters())
        gs = torch.autograd.grad(loss, params + ins[:3])
        out["decoder"] = flat(gs[: len(params)])
        out["dec_cots"] = [t.cpu() for t in gs[len(params):]]
        seen.clear()
        hook = m["decoder"].register_forward_pre_hook(
            lambda mod, args: seen.extend(args[:3]))
        tr.loss.generator_step(m, texts, lens, tr.style(m, waves), crop, src)
        hook.remove()
        params = list(m["predictor"].parameters())
        gs = torch.autograd.grad(seen, params, [c.to(dev) for c in at["cots"]],
                                 allow_unused=True)
        out["predictor"] = flat([torch.zeros_like(p) if x is None else x
                                 for p, x in zip(params, gs)])
    return out


def phase_slm(chk: Checks, root: Path, card: str, cfg_path: Path, windows):
    """The SLM (WavLM) adversarial stage. Full-width wavlm-base-plus on
    CUDA against the CPU on 3 s of 16 kHz audio (f32, seeded weights);
    its HF-layout state dict (parametrized positional-conv keys) loaded
    through slmadv_params.wavlm_path; one round at the small config on
    CUDA against the CPU (draws fixed; cuDNN off gated, on reported; split
    at the decoder's input as tests/test_torch_slm.py splits it);
    train_loop.main with the stage on at full width on phase 7's
    workspace (allow_random_wavlm, a round every SLM_ITER steps: each
    round's ms, launches and moved modules, peak memory); one round each
    of iSTFTNet and Vocos at full width on that run's first batch; the
    refusal without WavLM weights. Adds its windows to `windows`."""
    import copy
    import types

    import torch
    import yaml

    from styletts2_tpu_torch import train_loop
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.config import load_config, with_decoder_type
    from styletts2_tpu_torch.data.loader import bin_crop_frames, collate
    from styletts2_tpu_torch.models import build_inference_modules
    from styletts2_tpu_torch.nn import slm as SLM
    from styletts2_tpu_torch.nn import wavlm as WL
    from styletts2_tpu_torch.nn.discriminators import WavLMDiscriminator
    from styletts2_tpu_torch.ops import launch_count as LC
    from styletts2_tpu_torch.optim import MultiOptimizer
    from styletts2_tpu_torch.train import Batch

    tag = "[10 slm]"
    out = {}
    ws = cfg_path.parent
    base = yaml.safe_load(cfg_path.read_text())

    # full-width WavLM, CUDA vs CPU
    wavlm = WL.WavLM().init_random(torch.Generator().manual_seed(7))
    wavlm.eval().requires_grad_(False)
    n_params = sum(p.numel() for p in wavlm.parameters())
    wav = torch.from_numpy(style_clip(16000)[:48000][None].copy())
    with torch.no_grad():
        want, cpu_s = timed(lambda: wavlm(wav))
        gpu = copy.deepcopy(wavlm).cuda()
        gpu(wav.cuda())  # warm-up
        got, gpu_s = timed(lambda: gpu(wav.cuda()))
    rels = [rel_l2(a.cpu().numpy(), b.numpy()) for a, b in zip(got, want)]
    chk.check(len(got) == 13 and max(rels) < WAVLM_REL,
              f"{tag} WavLM CUDA vs CPU hidden states rel-l2 {rels}")
    print(f"{tag} wavlm-base-plus ({n_params} parameters, seeded) on 3 s of "
          f"16 kHz audio: {tuple(got[-1].shape)} x {len(got)} hidden states; "
          f"CUDA {gpu_s * 1e3:.1f} ms, CPU {cpu_s * 1e3:.1f} ms; rel-l2 per "
          f"hidden state CUDA vs CPU {', '.join(f'{r:.2e}' for r in rels)} "
          f"(bound {WAVLM_REL:g}) | {card}", flush=True)
    out["wavlm_cuda_vs_cpu"] = rels

    # its HF-layout state dict through slmadv_params.wavlm_path
    path = ws / "wavlm_hf.pt"
    torch.save(hf_layout(wavlm), path)
    cfg = load_config(dict(base, slmadv_params=dict(
        enabled=True, wavlm_path=str(path))))
    # on the CPU, where the forward is deterministic
    tr = SLM.build_trainer(cfg, MultiOptimizer({}), "cpu")
    direct = WL.WavLM()
    direct.load_hf_state_dict(torch.load(path, weights_only=True))
    direct.eval()
    with torch.no_grad():
        a, b = tr.wl.wavlm(wav), direct(wav)
    same_w = all(torch.equal(v, direct.state_dict()[k])
                 for k, v in tr.wl.wavlm.state_dict().items())
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    writer = max(rel_l2(x.numpy(), y.numpy()) for x, y in zip(a, want))
    chk.check(same_w and same, f"{tag} WavLM from wavlm_path == "
              "load_hf_state_dict of the same file, bit for bit")
    print(f"{tag} wavlm_path ({path.stat().st_size / 2 ** 20:.1f} MiB, "
          f"parametrized positional-conv keys) through build_trainer: "
          f"weights and hidden states (CPU) equal bit for bit to "
          f"load_hf_state_dict's {same_w and same}; vs the writer's (its "
          f"weight norm split and fused again) max rel-l2 {writer:.2e}",
          flush=True)
    del tr, direct, gpu, a, b, got
    torch.cuda.empty_cache()

    # one round at the small config, CUDA vs CPU, draws fixed
    raw = copy.deepcopy(TRAIN_TINY)
    raw["slmadv_params"] = {"enabled": True}
    tcfg = load_config(raw)
    mods = build_inference_modules(tcfg.model_params)
    W.init_random(mods, torch.Generator().manual_seed(3))
    W.split_weight_norm(mods)
    wd = WavLMDiscriminator()
    W.init_random(wd, torch.Generator().manual_seed(8))
    W.split_weight_norm(wd)
    rng = np.random.default_rng(3)
    b, t_text, t_mel, crop = 2, 12, 100, 33
    hop = tcfg.preprocess_params.spect_params.hop_length
    nb = types.SimpleNamespace(
        waves=(rng.standard_normal((b, t_mel * hop)) * 0.1).astype(np.float32),
        texts=rng.integers(4, 170, (b, t_text)),
        input_lengths=np.array([t_text, t_text - 3]))
    spf = mods["decoder"].generator.source_samples_per_frame
    rand_ini = rng.random((b, 9)).astype(np.float32)
    rand_ini[:, 0] = 0.0
    source = (torch.from_numpy(rand_ini), torch.from_numpy(
        rng.standard_normal((b, 2 * crop * spf, 9)).astype(np.float32)))
    args = (tcfg, mods, wavlm, wd, nb, crop, source)
    cpu = cpu_chain = slm_round_parts(*args, "cpu")
    res = {}
    for name, cudnn in (("without cuDNN", False), ("with cuDNN", True)):
        c = slm_round_parts(*args, "cuda", cudnn, at=cpu)

        def rel(x, y):
            return float((x - y).norm() / y.norm())

        r = dict(
            losses={k: abs(c["losses"][k] - v) / abs(v)
                    for k, v in cpu["losses"].items()},
            wavlm_d=rel(c["wavlm_d"], cpu["wavlm_d"]),
            decoder=rel(c["decoder"], cpu_chain["decoder"]),
            cotangents=max(rel(x, y) for x, y in zip(c["dec_cots"],
                                                     cpu_chain["dec_cots"])),
            predictor=rel(c["predictor"], cpu_chain["predictor"]),
            end_to_end={k: rel(c["end_to_end"][k], v)
                        for k, v in cpu["end_to_end"].items()})
        res[name] = r
        gated = [r["wavlm_d"], r["decoder"], r["cotangents"], r["predictor"]]
        chk.check(max(r["losses"].values()) < TRAIN_LOSS_REL,
                  f"{tag} small round CUDA ({name}) vs CPU losses {r}")
        if not cudnn:
            chk.check(max(gated) < TRAIN_GRAD_REL, f"{tag} small round "
                      f"CUDA without cuDNN vs CPU gradients {r}")
        print(f"{tag} one round at the small config, CUDA {name} vs CPU "
              f"(draws fixed): losses rel {r['losses']['slm_g']:.2e} / "
              f"{r['losses']['slm_d']:.2e} (bound {TRAIN_LOSS_REL:g}); "
              f"gradients rel-l2 wavlm_d {r['wavlm_d']:.2e}, decoder "
              f"{r['decoder']:.2e} and its input cotangents "
              f"{r['cotangents']:.2e} at the CPU's decoder inputs, predictor "
              f"{r['predictor']:.2e} along the CPU's cotangents ("
              + (f"bound {TRAIN_GRAD_REL:g}" if not cudnn else "reported")
              + "); end to end " + ", ".join(
                  f"{k} {v:.2e}" for k, v in r["end_to_end"].items())
              + " (reported)", flush=True)
    out["small_round"] = res
    del mods, wd

    # train_loop.main with the stage on, full width, phase 7's workspace
    slm_cfg = ws / "config_slm.yaml"
    slm_cfg.write_text(yaml.safe_dump(dict(
        base, log_dir=str(ws / "runs_slm"), save_freq=100,
        slmadv_params=dict(enabled=True, allow_random_wavlm=True,
                           iter=SLM_ITER)), allow_unicode=True))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LC.reset()
    with SLMRounds() as rec:
        trainer, wall = timed(lambda: train_loop.main(["-p", str(slm_cfg)]))
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    windows["slm train_loop"] = counts
    hist, rounds = trainer.history, rec.rounds
    n_rounds = len(hist) // SLM_ITER
    chk.check(len(rounds) == n_rounds >= 1, f"{tag} train_loop: "
              f"{len(rounds)} rounds in {len(hist)} steps")
    chk.check(counts == dict(b1=0, b2=B2_PER_STEP * len(hist) + B2_PER_EVAL
                             * len(trainer.evals) + len(rounds)),
              f"{tag} train_loop launches {counts}")
    logged = [h["metrics"] for h in hist if "slm_g" in h["metrics"]]
    chk.check(len(logged) == len(rounds) and all(
        np.isfinite(m[k]) for m in logged for k in ("slm_g", "slm_d")),
        f"{tag} slm_g / slm_d logged and finite {logged}")
    for i, r in enumerate(rounds):
        check_round(chk, r, f"{tag} train_loop round {i}")
        print(f"{tag} train_loop round {i} (after step {SLM_ITER * (i + 1)}):"
              f" {round_line(r)} | {card}", flush=True)
    print(f"{tag} train_loop.main, HiFi-GAN, batch 5, slmadv iter "
          f"{SLM_ITER}: {len(hist)} steps, {len(rounds)} rounds, "
          f"{len(trainer.evals)} eval batches in {wall:.1f} s; launches "
          f"{counts}; peak allocated {peak:.2f} GiB | {card}", flush=True)
    out["train_loop"] = dict(steps=len(hist), rounds=rounds, wall_s=wall,
                             peak_gib=peak, launches=counts)
    sampler = trainer.train_loader.sampler
    bin_id = sorted(sampler.time_bins)[0]
    idx = sampler.time_bins[bin_id][:trainer.cfg.batch_size]
    batch = Batch.from_numpy(collate(trainer.train_loader.dataset, idx,
                                     bin_id), "cuda")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # one round each of the other decoders at full width on that batch
    for dec_type in DECODER_TYPES:
        dcfg = load_config(with_decoder_type(dict(base, slmadv_params=dict(
            enabled=True, allow_random_wavlm=True)), dec_type))
        mods = build_inference_modules(dcfg.model_params)
        W.init_random(mods, torch.Generator().manual_seed(0))
        W.split_weight_norm(mods)
        mods.to("cuda").train()
        tr = SLM.build_trainer(dcfg, MultiOptimizer(mods), "cuda")
        gen = torch.Generator(device="cuda").manual_seed(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        LC.reset()
        with SLMRounds() as rec:
            tr.step(mods, batch.texts, batch.input_lengths, batch.waves,
                    bin_crop_frames(bin_id, dcfg.max_len), gen)
        windows[f"slm {dec_type}"] = launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        (r,) = rec.rounds
        check_round(chk, r, f"{tag} {dec_type} round")
        print(f"{tag} {dec_type} round at full width (batch "
              f"{batch.waves.shape[0]}, bin {bin_id}): {round_line(r)}; peak "
              f"allocated {peak:.2f} GiB | {card}", flush=True)
        out[dec_type] = dict(round=r, peak_gib=peak)
        del mods, tr
        gc.collect()
        torch.cuda.empty_cache()

    # the refusal without WavLM weights
    bad = ws / "config_slm_refused.yaml"
    bad.write_text(yaml.safe_dump(dict(base, log_dir=str(ws / "runs_refused"),
                                       slmadv_params=dict(enabled=True)),
                                  allow_unicode=True))
    try:
        train_loop.main(["-p", str(bad)])
        refused = "no error"
    except RuntimeError as e:
        refused = str(e)
    chk.check("requires slmadv_params.wavlm_path" in refused,
              f"{tag} enabled without WavLM weights: {refused}")
    print(f"{tag} enabled without wavlm_path or allow_random_wavlm: "
          f"train_loop raises: {refused[:80]}...", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: the multi-GPU paths (styletts2_tpu_torch/parallel/), one process
# per rank, launched as torchrun would launch them
# ---------------------------------------------------------------------------

PAR_TIMEOUT = 900  # s, for one group of rank processes
# the f32 seq-parallel engine against the f32 single-device engine on the
# same card: phase 6's tighter f32 gate (rel-l2)
SP_BOUND = BATCH_BOUND["float32"]
# parameters after one step, N ranks against one (tests/test_parallel.py)
STEP_RTOL, STEP_ATOL = 2e-3, 3e-4
# train_loop --distributed: the workspace's first bin (duration bin 15),
# its 10 training clips
PAR_TRAIN_STEPS = 2


def _clone(v):
    import torch

    return v.detach().clone() if isinstance(v, torch.Tensor) else v


class KernelProbe:
    """Keeps the inputs of the first B1 and B2 wrapper calls of a window
    (those calls launch and count as usual), so that after the window's
    counts are read each kernel is held against its plain version at the
    window's own shapes (B1: TOL / STATS_TOL of max(1, max |plain|); B2:
    atol 2e-5 + rtol 1e-4, phase 4's gate)."""

    def __init__(self):
        self.b1 = self.b2 = None

    def __enter__(self):
        from styletts2_tpu_torch.ops import mel_kernel as MK
        from styletts2_tpu_torch.ops import vocoder_kernel as VK

        self._b1, self._b2 = VK.ada_snake_conv, MK.log_mel
        probe = self

        def b1(*a, **k):
            if probe.b1 is None:
                probe.b1 = ([_clone(v) for v in a],
                            {n: _clone(v) for n, v in k.items()})
            return probe._b1(*a, **k)

        def b2(*a, **k):
            if probe.b2 is None:
                probe.b2 = ([_clone(v) for v in a],
                            {n: _clone(v) for n, v in k.items()})
            return probe._b2(*a, **k)

        VK.ada_snake_conv, MK.log_mel = b1, b2
        return self

    def __exit__(self, *exc):
        from styletts2_tpu_torch.ops import mel_kernel as MK
        from styletts2_tpu_torch.ops import vocoder_kernel as VK

        VK.ada_snake_conv, MK.log_mel = self._b1, self._b2
        return False

    def compare(self, chk: Checks, what: str) -> dict:
        import torch
        from styletts2_tpu_torch.ops import mel_kernel as MK
        from styletts2_tpu_torch.ops import vocoder_kernel as VK

        out = {}
        if self.b1 is not None:
            a, k = self.b1
            got, want = VK.ada_snake_conv(*a, **k), VK.ada_snake_conv_plain(
                *a, **k)
            stats = isinstance(got, tuple)
            go, wo = (got[0], want[0]) if stats else (got, want)
            name = str(go.dtype).split(".")[-1]
            scale = max(1.0, wo.float().abs().max().item())
            err = (go.float() - wo.float()).abs().max().item()
            ok = err <= TOL[name] * scale
            if stats:
                serr = ((got[1] - want[1]).abs().max().item()
                        / max(1.0, want[1].abs().max().item()))
                ok = ok and serr <= STATS_TOL[name]
            chk.check(ok, f"{what}: B1 {tuple(a[0].shape)} {name} vs plain "
                      f"err {err:.3g} of max {scale:.3g}")
            out["b1"] = dict(shape=list(a[0].shape), dtype=name,
                             max_abs_err=err, max_plain=scale)
        if self.b2 is not None:
            a, k = self.b2
            got, want = MK.log_mel(*a, **k), MK.log_mel_plain(*a, **k)
            err = (got - want).abs().max().item()
            chk.check(bool(torch.allclose(got, want, atol=2e-5, rtol=1e-4)),
                      f"{what}: B2 {tuple(a[0].shape)} vs plain err {err:.3g}")
            out["b2"] = dict(shape=list(a[0].shape), max_abs_err=err)
        return out


def probe_line(p) -> str:
    """The KernelProbe comparisons of a window, for its printed line."""
    parts = []
    if "b1" in p:
        b = p["b1"]
        parts.append(f"B1 {tuple(b['shape'])} {b['dtype']} vs plain max "
                     f"abs err {b['max_abs_err']:.3g} of max "
                     f"{b['max_plain']:.3g}")
    if "b2" in p:
        parts.append(f"B2 {tuple(p['b2']['shape'])} vs plain max abs err "
                     f"{p['b2']['max_abs_err']:.3g}")
    return "; ".join(parts) or "no kernel call"


def _counts_zero():
    from styletts2_tpu_torch.ops import launch_count as LC

    LC.reset()


def _synced_ms(fn, reps: int = 3):
    """Median synced wall ms of `reps` calls (after one warm-up call)."""
    timed(fn)
    return float(np.median([timed(fn)[1] * 1e3 for _ in range(reps)]))


def _par_models(cfg, path, dev):
    """The eight modules from the checkpoint at `path`, weight norm split,
    on `dev` in train mode, the pitch extractor frozen (train_loop's
    build)."""
    from styletts2_tpu_torch import weights as W
    from styletts2_tpu_torch.checkpoint import apply_checkpoint, load_checkpoint
    from styletts2_tpu_torch.models import build_model

    mods = build_model(cfg.model_params)
    W.split_weight_norm(mods)
    apply_checkpoint(mods, load_checkpoint(path))
    mods.to(dev).train()
    mods["pitch_extractor"].eval().requires_grad_(False)
    return mods


def _par_stepper(cfg, mods, crop, mesh, seed: int):
    """run(batch, draws, times) -> (metrics as floats, synced wall ms): D/G
    steps
    on `mods` (data-parallel over `mesh`, or single-process with mesh
    None) with the loop's optimizer settings and one generator."""
    import torch

    from styletts2_tpu_torch.optim import MultiOptimizer
    from styletts2_tpu_torch.train import (make_parallel_train_step,
                                          make_train_step)

    opt = MultiOptimizer(mods, lr=cfg.optimizer_params.lr,
                         ft_lr=cfg.optimizer_params.ft_lr)
    step = (make_train_step(cfg, opt, crop) if mesh is None
            else make_parallel_train_step(cfg, opt, mesh, crop))
    gen = torch.Generator(device=next(mods.parameters()).device
                          ).manual_seed(seed)

    def run(batch, draws=None, times=None):
        metrics, wall = timed(lambda: step(mods, batch, gen, draws, times))
        return {k: float(v) for k, v in metrics.items()}, wall * 1e3

    return run


def _param_diff(a, b):
    """(bit-identical, max abs difference, every tensor within STEP_RTOL /
    STEP_ATOL) of two module dicts' parameters."""
    import torch

    same, worst, close = True, 0.0, True
    for k in a:
        for pa, pb in zip(a[k].parameters(), b[k].parameters()):
            same = same and torch.equal(pa, pb)
            worst = max(worst, (pa - pb).abs().max().item())
            close = close and torch.allclose(pa, pb, rtol=STEP_RTOL,
                                             atol=STEP_ATOL)
    return same, worst, close


def _par_engines(cfg, mesh, chk: Checks, tag: str, card: str, rank0: bool):
    """The data-parallel bf16 engine's generate_batch on the eight texts
    against the single-device engine's generate of each (rank 0), with B1
    and B2 counted and probed in the data-parallel window; then the f32
    seq-parallel engine against the f32 single engine on the short text.
    Returns the results."""
    import copy

    import torch
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.parallel import seqpar as SP

    out = {}
    per_eval = b1_per_eval(cfg.model_params.decoder)
    dev = mesh.device
    dp = StyleTTS2(copy.deepcopy(cfg), seed=0, mesh=mesh, device=dev.type)
    dp.duration_scale = DURATION_SCALE
    clip = style_clip(dp.sr)
    dp.generate_batch(BATCH_TEXTS[:2], {"style": dp.compute_style(clip),
                                        "speed": 1.0}, stabilize=False)
    torch.cuda.synchronize()
    _counts_zero()
    dp.phase2_calls = 0
    with KernelProbe() as probe:
        style = {"style": dp.compute_style(clip), "speed": 1.0}
        outs, wall = timed(lambda: dp.generate_batch(BATCH_TEXTS, style,
                                                     stabilize=False))
    c = dict(phase2_calls=dp.phase2_calls, replays=0, **launches())
    check_b1_counts(chk, c, f"{tag} data-parallel generate_batch", per_eval)
    chk.check(c["b2"] >= 1, f"{tag} data-parallel compute_style B2")
    out["dp_window"] = c
    out["dp_probe"] = probe.compare(chk, f"{tag} data-parallel window")
    if rank0:
        print(f"[11 parallel] {tag} data-parallel window: "
              f"{probe_line(out['dp_probe'])}", flush=True)
    secs = sum(len(w) for w in outs) / dp.sr
    out["dp_wall_ms"] = wall * 1e3
    out["dp_digest"] = float(sum(np.abs(w).sum() for w in outs))
    if rank0:
        one = StyleTTS2(copy.deepcopy(cfg), seed=0, device=dev)
        one.duration_scale = DURATION_SCALE
        rel = []
        for text, got in zip(BATCH_TEXTS, outs):
            want = one.generate(text, style, stabilize=False)
            rel.append(rel_l2(got, want) if got.shape == want.shape
                       else 1.0)
        spread = phase2_spread(one, BATCH_TEXTS[0], style, probes=False)
        bound = BATCH_BOUND["bfloat16"]
        chk.check(max(rel) < bound, f"{tag} data-parallel generate_batch vs "
                  f"generate rel-l2 {rel}")
        out["dp_rel_l2"], out["dp_spread"] = rel, spread
        print(f"[11 parallel] {tag} data-parallel engine ({mesh.size} "
              f"ranks, batch buckets {dp.batch_buckets}): generate_batch "
              f"{len(BATCH_TEXTS)} texts, {secs:.2f} s audio in "
              f"{wall * 1e3:.1f} ms, {c['phase2_calls']} phase-2 calls on "
              f"this rank, launches {c}; each text vs the single engine's "
              f"generate rel-l2 {', '.join(f'{r:.3g}' for r in rel)} "
              f"(bound {bound:g}); one phase-2 call on identical inputs "
              f"moves {spread['batch8']:.3g} at batch 8 vs 1 and "
              f"{spread['next_bucket']:.3g} at the next frame bucket "
              f"(phase2_spread) | {card}",
              flush=True)
        del one
    del dp
    gc.collect()
    torch.cuda.empty_cache()

    calls = []
    orig = SP.sp_decoder_apply

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    SP.sp_decoder_apply = spy
    try:
        sp = StyleTTS2(copy.deepcopy(cfg), seed=0, mesh=mesh,
                       seq_parallel=True, decoder_dtype="float32",
                       device=dev.type)
        style32 = {"style": sp.compute_style(clip), "speed": 1.0}
        wav_sp, wall_sp = timed(lambda: sp.generate(TEXTS["short"], style32))
    finally:
        SP.sp_decoder_apply = orig
    out["sp_decodes"] = len(calls)
    chk.check(len(calls) >= 1, f"{tag} seq-parallel decode taken")
    out["sp_digest"] = float(np.abs(wav_sp).sum())
    one = None
    if rank0:
        one = StyleTTS2(copy.deepcopy(cfg), seed=0, decoder_dtype="float32",
                        device=dev)
        one.fused_enabled = False
    # the decode alone at frame bucket 512 (every rank: the frame-sharded
    # decode's collectives), the plain decoder on rank 0, on the same
    # phase-2 inputs
    with torch.inference_mode():
        tokens = torch.ones(1, 64, dtype=torch.int64, device=dev)
        mask = torch.ones(1, 64, dtype=torch.bool, device=dev)
        s = sp._style_row(style32["style"])
        t_en, d, _ = sp._phase1(tokens, mask, s)
        durs = torch.full((1, 64), 8, dtype=torch.int32, device=dev)
        pros = sp._prosody(t_en, d, s, durs, 512)
        sp_ms = _synced_ms(lambda: sp._decode(*pros[:3], s, pros[3]))
        if rank0:
            plain_ms = _synced_ms(lambda: one._decode(*pros[:3], s,
                                                      pros[3]))
    out.update(sp_decode_ms=sp_ms, sp_generate_ms=wall_sp * 1e3)
    dep = _sp_departure(sp, one, mesh, pros, s, tag, card)
    if dep and mesh.size > 1:
        # a halo fault would put the difference at the core boundaries:
        # they may hold no more of it than their share of the frames
        chk.check(dep["sp_n_boundary_share"] <= dep["sp_boundary_frames"],
                  f"{tag} frame-sharded decode: "
                  f"{dep['sp_n_boundary_share']:.3g} of the squared "
                  f"difference from one rank within the margin of a core "
                  f"boundary, more than that band's "
                  f"{dep['sp_boundary_frames']:.3g} of the frames")
    out.update(dep)
    if rank0:
        wav_1 = one.generate(TEXTS["short"], {"style": one.compute_style(
            clip), "speed": 1.0})
        ok = wav_sp.shape == wav_1.shape
        rel = rel_l2(wav_sp, wav_1) if ok else 1.0
        steps = (int(np.abs(np.round(wav_sp * 32767)
                            - np.round(wav_1 * 32767)).max()) if ok else -1)
        chk.check(ok and rel < SP_BOUND, f"{tag} f32 seq-parallel vs single "
                  f"engine rel-l2 {rel:.3g}")
        out.update(sp_rel_l2=rel, sp_int16_steps=steps,
                   plain_decode_ms=plain_ms)
        print(f"[11 parallel] {tag} f32 seq-parallel engine ({mesh.size} "
              f"ranks, margin {sp._sp_margin}): short text {len(wav_sp)} "
              f"samples, {len(calls)} frame-sharded decodes, vs the f32 "
              f"single engine rel-l2 {rel:.3g} (bound {SP_BOUND:g}), largest "
              f"difference {steps} int16 steps; decode at frame bucket 512: "
              f"seq-parallel {sp_ms:.1f} ms, plain {plain_ms:.1f} ms | "
              f"{card}", flush=True)
        del one
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sp_departure(sp, one, mesh, pros, s, tag: str, card: str):
    """Where the f32 frame-sharded decode departs from a one-rank one, on
    the phase-2 inputs of the decode timing (frame bucket 512): every rank
    decodes over `mesh`; rank 0 also decodes over a one-rank group (the
    whole sequence as one window), with the plain decoder, and over one
    rank twice more: with the decoder input moved by one f32 ulp at
    random signs, and with every AdaIN mean and variance moved by one ulp
    (the size of the rounding that summing the statistics in parts
    changes). Returns rank 0's numbers: rel-l2 and the largest int16 step
    of each against the one-rank decode, and for the N-rank decode and
    the moved statistics the asr frame of the largest difference, its
    distance from the nearest interior core boundary and from the nearest
    end of the valid frames, and the shares of the squared difference
    within +-margin frames of a core boundary and within 2 frames of an
    end, beside those bands' shares of the frames."""
    import torch
    import torch.distributed as dist
    from styletts2_tpu_torch.nn import layers as L
    from styletts2_tpu_torch.parallel import Mesh
    from styletts2_tpu_torch.parallel import seqpar as SP

    # a one-rank group; every rank takes part in making it
    sub = dist.new_group([0]) if mesh.size > 1 else None
    asr, f0, n_en, frame_mask = pros[:4]
    s = s.float()
    dec = sp.modules["decoder"]

    @torch.inference_mode()
    def decode(m, x):
        w = SP.sp_decoder_apply(m, dec, x, f0.float(), n_en.float(), s,
                                margin=sp._sp_margin,
                                n_valid=frame_mask.sum(dim=1))
        return w[0, :, 0].float().cpu().numpy()

    w_n = decode(mesh, asr)
    if mesh.rank != 0:
        return {}
    one_rank = mesh if sub is None else Mesh(sub, 0, 1, mesh.device, "sp")
    w_1 = decode(one_rank, asr)
    with torch.inference_mode():
        sign = torch.randint(0, 2, asr.shape, generator=torch.Generator(
            ).manual_seed(0)).to(asr.device) * 2 - 1
        nudged = asr * (1 + sign * 2.0 ** -23)
        w_plain = one.modules["decoder"](asr, f0.float(), n_en.float(), s,
                                         frame_mask)[0, :, 0].float()
    w_plain = w_plain.cpu().numpy()
    w_ulp = decode(one_rank, nudged)
    stats = L.masked_stats

    def moved_stats(xf, m):
        mean, var = stats(xf, m)
        return mean * (1 + 2.0 ** -23), var * (1 + 2.0 ** -23)

    L.masked_stats = moved_stats
    try:
        w_stat = decode(one_rank, asr)
    finally:
        L.masked_stats = stats

    def steps(a, b):
        q = lambda w: np.round(np.clip(w, -1, 1) * 32767)  # noqa: E731
        return int(np.abs(q(a) - q(b)).max())

    n_frames = frame_mask.shape[1]
    n_valid = int(frame_mask.sum())
    spf = len(w_n) // n_frames  # samples per asr frame
    frames = np.arange(len(w_n)) // spf
    bounds = [k * n_frames // mesh.size for k in range(1, mesh.size)]
    core_band = np.zeros(len(w_n), bool)
    for b in bounds:
        core_band |= np.abs(frames - b) < sp._sp_margin
    ends = (frames < 2) | (np.abs(frames - (n_valid - 1)) < 2)

    def where(w, key):
        d2 = (w - w_1) ** 2
        frame = int(np.argmax(d2)) // spf
        total = max(float(d2.sum()), 1e-30)
        return {f"{key}_rel": rel_l2(w, w_1), f"{key}_steps": steps(w, w_1),
                f"{key}_worst_frame": frame,
                f"{key}_from_boundary": (min(abs(frame - b) for b in bounds)
                                         if bounds else -1),
                f"{key}_from_end": min(frame, abs(frame - (n_valid - 1))),
                f"{key}_boundary_share": float(d2[core_band].sum() / total),
                f"{key}_end_share": float(d2[ends].sum() / total)}

    out = dict(where(w_n, "sp_n"), **where(w_stat, "sp_stat"),
               sp_plain_rel=rel_l2(w_plain, w_1),
               sp_plain_steps=steps(w_plain, w_1),
               sp_ulp_rel=rel_l2(w_ulp, w_1), sp_ulp_steps=steps(w_ulp, w_1),
               sp_boundary_frames=float(core_band.mean()),
               sp_end_frames=float(ends.mean()))

    def line(key):
        return (f"rel-l2 {out[key + '_rel']:.3g}, {out[key + '_steps']} "
                f"int16 steps, largest at asr frame "
                f"{out[key + '_worst_frame']} ({out[key + '_from_end']} from "
                f"an end of the {n_valid} valid frames, "
                f"{out[key + '_from_boundary']} from a core boundary; -1: "
                f"none); {100 * out[key + '_end_share']:.1f}% of the "
                f"squared difference within 2 frames of an end, "
                f"{100 * out[key + '_boundary_share']:.1f}% within "
                f"+-{sp._sp_margin} of a core boundary")

    print(f"[11 parallel] {tag} f32 frame-sharded decode at frame bucket "
          f"{n_frames} against one rank (bands: ends "
          f"{100 * out['sp_end_frames']:.1f}%, core boundaries "
          f"{100 * out['sp_boundary_frames']:.1f}% of the frames): "
          f"{mesh.size} rank(s) {line('sp_n')}; one rank with every AdaIN "
          f"statistic moved by one ulp {line('sp_stat')}; the input moved "
          f"by one ulp rel-l2 {out['sp_ulp_rel']:.3g} "
          f"({out['sp_ulp_steps']} steps); the plain decoder rel-l2 "
          f"{out['sp_plain_rel']:.3g} ({out['sp_plain_steps']} steps) | "
          f"{card}", flush=True)
    return out


def parallel_11a(spec, mesh, chk: Checks, card: str):
    """World size 1 over NCCL: train_loop --distributed on phase 7's
    workspace (PAR_TRAIN_STEPS steps), the data-parallel step against
    make_train_step on the same batch and generator state, then the
    engines (_par_engines)."""
    import torch
    from styletts2_tpu_torch import train_loop
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.data.loader import bin_crop_frames, collate
    from styletts2_tpu_torch.train import Batch, PhaseTimes

    out = {}
    _counts_zero()
    with KernelProbe() as probe:
        trainer, wall = timed(lambda: train_loop.main(
            ["-p", spec["train_cfg"], "--distributed"],
            device=mesh.device.type))
    c = launches()
    hist, evals = trainer.history, trainer.evals
    finite = all(np.isfinite(v) for h in hist for v in h["metrics"].values())
    chk.check(len(hist) == PAR_TRAIN_STEPS and finite,
              f"11a train_loop --distributed: {len(hist)} steps, finite "
              f"{finite}")
    chk.check(c["b2"] == B2_PER_STEP * len(hist) + B2_PER_EVAL * len(evals)
              and c["b1"] == 0, f"11a train_loop launches {c}")
    out["train_window"] = c
    out["train_probe"] = probe.compare(chk, "11a train_loop window")
    print(f"[11 parallel] 11a train_loop window: "
          f"{probe_line(out['train_probe'])}", flush=True)
    step_ms = ", ".join(f"{h['step_ms']:.1f}" for h in hist)
    print(f"[11 parallel] 11a train_loop --distributed (1 rank, "
          f"{trainer.mesh}): {len(hist)} steps, {len(evals)} eval batches "
          f"in {wall:.1f} s, launches {c}, host ms per step call "
          f"{step_ms} | {card}", flush=True)

    cfg = load_config(spec["train_cfg"])
    sampler = trainer.train_loader.sampler
    bin_id = sorted(sampler.time_bins)[0]
    idx = sampler.time_bins[bin_id][:cfg.batch_size]
    batch = Batch.from_numpy(collate(trainer.train_loader.dataset, idx,
                                     bin_id), mesh.device)
    crop = bin_crop_frames(bin_id, cfg.max_len)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    runs, first = {}, {}
    for name, mesh_or_none in (("data-parallel", mesh), ("single", None)):
        mods = _par_models(cfg, spec["seed_ckpt"], mesh.device)
        runs[name] = (mods, _par_stepper(cfg, mods, crop, mesh_or_none, 3))
        first[name] = runs[name][1](batch)[0]
    same, worst, close = _param_diff(runs["data-parallel"][0],
                                     runs["single"][0])
    m_dp, m_1 = first["data-parallel"], first["single"]
    chk.check(close and all(abs(m_dp[k] - m_1[k]) <= 1e-3 * abs(m_1[k])
                            for k in m_1),
              f"11a data-parallel step vs make_train_step: max abs "
              f"{worst:.3g}")
    # then two more steps of each, in turns (the first steps paid for the
    # cuDNN plans and the optimizer states)
    ms = {name: [] for name in runs}
    for name in ("data-parallel", "single", "single", "data-parallel"):
        ms[name].append(runs[name][1](batch)[1])
    # one more step of each split at the step's marks (train.PhaseTimes,
    # synchronised at each: d_sync / g_sync are the data-parallel step's
    # all-reduces and the copies around them)
    split = {}
    for name in ("data-parallel", "single"):
        split[name] = PhaseTimes(mesh.device)
        runs[name][1](batch, times=split[name])
        split[name] = split[name].ms
    out.update(step_identical=same, step_max_abs=worst,
               dp_step_ms=ms["data-parallel"], single_step_ms=ms["single"],
               step_phases_ms=split)
    print(f"[11 parallel] 11a data-parallel step (1 rank) vs make_train_step"
          f" on bin {bin_id}'s batch of {cfg.batch_size}, one generator "
          f"state: parameters bit-identical {same}, max abs {worst:.3g}; "
          f"synced wall of steps 2-3, in turns: data-parallel "
          f"{', '.join(f'{t:.1f}' for t in ms['data-parallel'])} ms, "
          f"single {', '.join(f'{t:.1f}' for t in ms['single'])} ms | "
          f"{card}", flush=True)
    print("[11 parallel] 11a step phases, ms (one more step each, synced at "
          "each mark): " + "; ".join(
              f"{name} " + ", ".join(f"{k} {v:.1f}" for k, v in t.items())
              for name, t in split.items()) + f" | {card}", flush=True)
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    out.update(_par_engines(load_config(spec["engine_cfg"]), mesh, chk,
                            "11a", card, True))
    return out


def parallel_11b(spec, mesh, chk: Checks, card: str):
    """Two ranks on the one card over gloo with CUDA tensors: the engines
    (_par_engines) at 2 ranks against 1, then the data-parallel step at
    global batch 4 (2 rows per rank) against one process's step on the
    same batch, draws fixed and dropout off."""
    import torch
    from styletts2_tpu_torch.config import load_config
    from styletts2_tpu_torch.data import build_dataloader
    from styletts2_tpu_torch.data.loader import bin_crop_frames
    from styletts2_tpu_torch.parallel import shard_batch
    from styletts2_tpu_torch.text import build_symbol_dict
    from styletts2_tpu_torch.train import Batch, Draws

    rank0 = mesh.rank == 0
    out = _par_engines(load_config(spec["engine_cfg"]), mesh, chk, "11b",
                       card, rank0)
    cfg = load_config(spec["train_cfg"])
    with open(cfg.data_params.train_data, encoding="utf-8") as f:
        loader = build_dataloader(f.readlines(), cfg.data_params.root_path,
                                  build_symbol_dict(cfg.symbol),
                                  batch_size=4, debug=False)
    bin_id, nb = next(iter(loader))
    batch = Batch.from_numpy(nb, mesh.device)
    crop = bin_crop_frames(bin_id, cfg.max_len)
    mods = _par_models(cfg, spec["seed_ckpt"], mesh.device)
    rng = np.random.default_rng(5)
    max_start = np.maximum(nb.mel_lengths // 2 - crop, 0)
    spf = mods["decoder"].generator.source_samples_per_frame
    rand_ini = rng.random((4, 9)).astype(np.float32)
    rand_ini[:, 0] = 0.0
    source = None if not spf else (
        torch.from_numpy(rand_ini), torch.from_numpy(rng.standard_normal(
            (4, 2 * crop * spf, 9)).astype(np.float32)))
    draws = Draws(coin=True, dropout=False, source=source,
                  starts=torch.from_numpy(rng.integers(0, max_start + 1)))
    local, local_draws = shard_batch(mesh, (batch, draws))
    m_dp, dp_ms = _par_stepper(cfg, mods, crop, mesh, 4)(local, local_draws)
    out["step_params_digest"] = float(sum(
        p.double().abs().sum().item() for p in mods.parameters()))
    out["dp_step_ms"] = dp_ms
    torch.cuda.empty_cache()
    if rank0:
        one = _par_models(cfg, spec["seed_ckpt"], mesh.device)
        m_1, one_ms = _par_stepper(cfg, one, crop, None, 4)(
            batch, shard_batch(mesh, draws, local=True))
        same, worst, close = _param_diff(mods, one)
        chk.check(close and all(abs(m_dp[k] - m_1[k]) <= 1e-3 * abs(m_1[k])
                                for k in m_1),
                  f"11b data-parallel step (2 ranks) vs one process: max "
                  f"abs {worst:.3g}")
        out.update(step_identical=same, step_max_abs=worst,
                   single_step_ms=one_ms)
        print(f"[11 parallel] 11b data-parallel step, 2 ranks x 2 rows of "
              f"bin {bin_id} vs one process on the 4 rows (draws fixed, "
              f"dropout off): parameters within rtol {STEP_RTOL:g} / atol "
              f"{STEP_ATOL:g} {close}, max abs {worst:.3g}, losses "
              + ", ".join(f"{k} {m_dp[k]:.4f}/{m_1[k]:.4f}" for k in m_1)
              + f"; synced wall (two processes share one device, not a "
              f"speed) {dp_ms:.1f} ms vs one process {one_ms:.1f} ms | "
              f"{card}", flush=True)
    return out


def parallel_worker(spec_path: str) -> int:
    """One rank of phase 11 (`--parallel-worker SPEC`): joins the process
    group from the environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), runs 11a or 11b and writes its results and failed
    checks to the spec's out file for its rank."""
    spec = json.loads(Path(spec_path).read_text())
    sys.path.insert(0, spec["root"])
    import torch
    import torch.distributed as dist
    from styletts2_tpu_torch.parallel import init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    dev = init_distributed("cuda", backend=spec["backend"])
    mesh = make_mesh(device=dev)
    chk = Checks()
    try:
        fn = parallel_11a if spec["phase"] == "11a" else parallel_11b
        out = fn(spec, mesh, chk, spec["card"])
        out["launches"] = launches()
    finally:
        dist.destroy_process_group()
    Path(spec["out"].format(rank=mesh.rank)).write_text(json.dumps(
        dict(out, failed=chk.failed), default=float))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(root: Path, spec: dict, world: int, local_ranks):
    """Start `world` rank processes of this script with torchrun's
    environment, wait for every one (killing the group on a timeout or a
    failure) and return their results in rank order."""
    import os

    work = root / "build" / "parallel_smoke"
    work.mkdir(parents=True, exist_ok=True)
    spec = dict(spec, out=str(work / (spec["phase"] + "_rank{rank}.json")))
    spec_path = work / f"{spec['phase']}_spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parallel-worker",
         str(spec_path)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(local_ranks[r])))
        for r in range(world)]
    try:
        deadline = time.perf_counter() + PAR_TIMEOUT
        while any(p.poll() is None for p in procs):
            if (time.perf_counter() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    results = []
    for r in range(world):
        path = Path(spec["out"].format(rank=r))
        results.append(json.loads(path.read_text()) if path.exists()
                       and codes[r] == 0 else None)
    return codes, results


def phase_parallel(chk: Checks, root: Path, card: str, cfg_path: Path,
                   windows):
    """Phase 11: the multi-GPU paths, one process per rank with torchrun's
    environment, the kernels already built by this process (phase 2):
    11a world size 1 over NCCL, 11b two ranks on the one card over gloo
    with CUDA tensors. Adds each rank's windows to `windows`."""
    import torch
    import yaml

    t0 = time.perf_counter()
    ws = cfg_path.parent
    train_cfg = ws / "config_parallel.yaml"
    raw = yaml.safe_load(cfg_path.read_text())
    lines = (ws / "train_list.txt").read_text().splitlines(True)
    # the first bin's training clips only: PAR_TRAIN_STEPS steps of batch 5
    (ws / "train_list_parallel.txt").write_text("".join(
        lines[:PAR_TRAIN_STEPS * raw["batch_size"]]))
    raw["data_params"]["train_data"] = str(ws / "train_list_parallel.txt")
    raw["log_dir"] = str(ws / "runs_parallel")
    train_cfg.write_text(yaml.safe_dump(raw, allow_unicode=True))
    spec = dict(root=str(root), card=card, train_cfg=str(train_cfg),
                seed_ckpt=str(ws / "seed.ckpt"),
                engine_cfg=str(root / "configs" / "config_example.yaml"))
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for phase, world, backend in (("11a", 1, "nccl"), ("11b", 2, "gloo")):
        t1 = time.perf_counter()
        codes, res = _run_ranks(root, dict(spec, phase=phase,
                                           backend=backend),
                                world, [0] * world)
        ok = all(c == 0 for c in codes) and all(r is not None for r in res)
        chk.check(ok, f"[11 parallel] {phase} rank exit codes {codes}")
        if not ok:
            continue
        for r, rr in enumerate(res):
            for f in rr["failed"]:
                chk.check(False, f"{phase} rank {r}: {f}")
            for key in ("train_window", "dp_window"):
                if key in rr:
                    windows[f"parallel_{phase}_{key}_rank{r}"] = rr[key]
        if world > 1:
            for key in ("dp_digest", "sp_digest", "step_params_digest"):
                same = len({rr[key] for rr in res}) == 1
                chk.check(same, f"{phase}: every rank's {key} equal")
        out[phase] = res
        print(f"[11 parallel] {phase}: {world} rank(s) over {backend} in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
    print(f"[11 parallel] phase wall {time.perf_counter() - t0:.1f} s | "
          f"{card}", flush=True)
    return out


# ---------------------------------------------------------------------
# phase 12: ONNX export and its runtime
# ---------------------------------------------------------------------

def onnx_reference(mods, tokens, style, speed: float, device="cuda",
                   dtype=None):
    """The exported graph's pipeline composed from the port's modules, as
    tests/test_onnx.py::_jax_forward composes the JAX package's: text
    encoder, encode_duration, duration_head, the outlier clamp on
    dur[1:-2] (torch's unbiased std), / speed, round (>= 1), the 0/1
    alignment, f0n, then the decoder in `dtype` (the decoder's packed
    dtype; default f32) with an all-valid frame mask and no source draws:
    the deterministic sine path, every AdaINResBlock1 conv pair through
    kernel B1 on CUDA and its plain version on the CPU. mods: the text
    encoder, predictor and decoder on `device`. Returns (the waveform
    trimmed by 4000 samples at each end as the graph trims it, f32 numpy;
    the durations, int64)."""
    import torch

    dev = torch.device(device)
    dt = dtype or torch.float32
    pred, dec = mods["predictor"], mods["decoder"]
    with torch.inference_mode():
        tok = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)[None]
        mask = torch.ones(tok.shape, dtype=torch.bool, device=dev)
        s = torch.as_tensor(np.asarray(style, np.float32), device=dev)
        t_en = mods["text_encoder"](tok, mask)  # (1, T, C)
        d = pred.encode_duration(t_en, s, mask)
        dur = torch.sigmoid(pred.duration_head(d, mask)).sum(-1)[0]
        dur = dur.cpu().numpy()

        mid = dur[1:-2]
        mean, std = mid.mean(), mid.std(ddof=1)  # torch .std() is unbiased
        repl = mean + np.sign(mid - mean) * (3.0 * std * 0.95)
        mid = np.where(np.abs((mid - mean) / std) > 3.0, repl, mid)
        dur = np.concatenate([dur[:1], mid, dur[-2:]])
        pred_dur = np.clip(np.round(dur / speed), 1, None).astype(np.int64)

        frames = int(pred_dur.sum())
        align = np.zeros((len(pred_dur), frames), np.float32)
        c = 0
        for i, di in enumerate(pred_dur):
            align[i, c:c + di] = 1.0
            c += di
        align_t = torch.from_numpy(np.ascontiguousarray(align.T)).to(dev)[None]
        f0, n = pred.f0n(torch.matmul(align_t, d), s)
        asr = torch.matmul(align_t, t_en)
        wav = dec(asr.to(dt), f0.float(), n.float(), s.to(dt),
                  torch.ones(1, frames, dtype=torch.bool, device=dev))
        wav = wav[0, :, 0].float().cpu().numpy()
    return wav[4000:-4000], pred_dur


ONNX_DECODERS = ("hifigan", "istftnet", "vocos")
# the graph against the CPU graph and the composed f32 modules: the JAX
# suite's gate for its runtime against its forward (max |got - want| /
# max |want|)
ONNX_GATE = 5e-3
# the utterance's length at the chosen speed, in frames: random weights
# predict ~5x the natural durations, and the graph takes no duration scale
ONNX_FRAMES = 300


def _pcm(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int64)


def phase_onnx(chk: Checks, root: Path, card: str, windows, spreads=None):
    """Phase 12: per decoder (config_example.yaml's widths; iSTFTNet and
    Vocos with phase 8's config edits; seeded random weights, the engine's
    seed 0, f32 decoder), `export_modules` of the engine's modules (wall
    time, size), the file through `OnnxModel` on CUDA on the short text's
    tokens with the style of phase 5's clip, at a speed that keeps the
    utterance near ONNX_FRAMES frames; held at ONNX_GATE against the same
    graph on the CPU and against `onnx_reference` (the port's modules
    composed on CUDA, f32 decoder: B1 per b1_per_eval in the window,
    KernelProbe on its first call); the bf16 decoder's composition
    reported beside the decoder's phase2_spread (`spreads`, from phases 5
    and 8); the graph's and the composed forward's wall ms (median of 3
    after a warm run). Adds the "onnx" window to `windows`."""
    import torch
    import yaml

    from styletts2_tpu_torch.config import load_config, with_decoder_type
    from styletts2_tpu_torch.infer import StyleTTS2
    from styletts2_tpu_torch.onnx import export_modules
    from styletts2_tpu_torch.onnx.runtime import OnnxModel
    from styletts2_tpu_torch.text import tokens_for_sentence

    t_phase = time.perf_counter()
    raw = yaml.safe_load((root / "configs" / "config_example.yaml")
                         .read_text())
    spreads = spreads or {}
    total = {"b1": 0, "b2": 0}
    out, style, speed, tokens = {}, None, None, None
    for dec_type in ONNX_DECODERS:
        tag = f"[12 onnx {dec_type}]"
        cfg = load_config(with_decoder_type(raw, dec_type))
        per_eval = b1_per_eval(cfg.model_params.decoder)
        engine = StyleTTS2(cfg, seed=0, decoder_dtype="float32")
        if style is None:  # phase 5's engine, clip and text
            style = engine.compute_style(style_clip(engine.sr))
            tokens = np.asarray(tokens_for_sentence(TEXTS["short"],
                                                    engine.cleaner), np.int64)
            with torch.inference_mode():
                tok = torch.from_numpy(tokens).to(engine.device)[None]
                mask = torch.ones_like(tok, dtype=torch.bool)
                dur = engine._phase1(tok, mask, style.reshape(1, -1))[2]
            raw_frames = float(dur.sum())
            speed = np.float32(max(1.0, round(raw_frames / ONNX_FRAMES, 2)))
            print(f"[12 onnx] short text: {len(tokens)} tokens, style "
                  f"{tuple(style.shape)} of phase 5's clip; ~{raw_frames:.0f}"
                  f" frames at speed 1, graph speed {speed}", flush=True)
        s_np = style.reshape(1, -1).float().cpu().numpy()
        feeds = {"tokens": tokens, "style": s_np, "speed": speed}
        n_params = sum(p.numel() for k in ("text_encoder", "predictor",
                                           "decoder")
                       for p in engine.modules[k].parameters())
        data, t_export = timed(lambda: export_modules(engine, cfg))
        model, t_load = timed(lambda: OnnxModel(data, device="cuda"))
        n_nodes = len(model.nodes)
        print(f"{tag} export_modules: {n_params} parameters, {n_nodes} "
              f"nodes, {len(data) / 1e6:.1f} MB in {t_export:.2f} s; "
              f"OnnxModel(cuda) load {t_load:.2f} s | {card}", flush=True)

        graph_ms = _synced_ms(lambda: model.run(feeds))
        got = model.run(feeds)[0]
        chk.check(got.ndim == 1 and len(got) > 0 and bool(np.isfinite(
            got).all()), f"{tag} graph output finite, {got.shape}")
        cpu_model = OnnxModel(data, device="cpu")
        got_cpu, t_cpu = timed(lambda: cpu_model.run(feeds)[0])
        del cpu_model
        same_len = got_cpu.shape == got.shape
        cpu_err = scaled_max_err(got, got_cpu) if same_len else float("inf")
        chk.check(same_len and cpu_err <= ONNX_GATE,
                  f"{tag} graph CUDA vs CPU: {got.shape} vs "
                  f"{got_cpu.shape}, scaled max {cpu_err:.3g}")

        mods = engine.modules
        _counts_zero()
        with KernelProbe() as probe:
            ref, pred_dur = onnx_reference(mods, tokens, s_np, float(speed),
                                           "cuda", torch.float32)
        c = launches()
        chk.check(c["b1"] == per_eval and c["b2"] == 0,
                  f"{tag} B1 launches of the f32 composition {c} (want "
                  f"{per_eval})")
        probes = probe.compare(chk, f"{tag} composed f32")
        for k in total:
            total[k] += c[k]
        same_len = ref.shape == got.shape
        ref_err = scaled_max_err(got, ref) if same_len else float("inf")
        pcm_diff = (int(np.abs(_pcm(got) - _pcm(ref)).max()) if same_len
                    else None)
        chk.check(same_len and ref_err <= ONNX_GATE,
                  f"{tag} graph vs the composed f32 modules: {got.shape} vs "
                  f"{ref.shape}, scaled max {ref_err:.3g}")
        ref_ms = _synced_ms(lambda: onnx_reference(
            mods, tokens, s_np, float(speed), "cuda", torch.float32))

        mods["decoder"].prepack(torch.bfloat16)
        _counts_zero()
        ref16, _ = onnx_reference(mods, tokens, s_np, float(speed), "cuda",
                                  torch.bfloat16)
        c16 = launches()
        chk.check(c16["b1"] == per_eval, f"{tag} B1 launches of the bf16 "
                  f"composition {c16}")
        for k in total:
            total[k] += c16[k]
        bf16_rel = rel_l2(got, ref16) if ref16.shape == got.shape else None
        bf16_s = (f"{bf16_rel:.3g}" if bf16_rel is not None
                  else f"lengths {ref16.shape} vs {got.shape}")
        spread = spreads.get(dec_type)
        spread_s = ("not measured in this run" if spread is None
                    else f"{spread:.3g}")
        frames = int(pred_dur.sum())
        print(f"{tag} {frames} frames, {len(got)} samples: graph CUDA vs "
              f"CPU scaled max {cpu_err:.3g}; vs the composed f32 modules "
              f"scaled max {ref_err:.3g}, largest int16 difference "
              f"{pcm_diff} (gate {ONNX_GATE:g}); B1 {c['b1']} launches "
              f"({probe_line(probes)}); the bf16 composition vs the graph "
              f"rel-l2 {bf16_s} (reported; this decoder's bf16 "
              f"phase2_spread {spread_s})", flush=True)
        print(f"{tag} wall ms, median of 3 after a warm run: graph on CUDA "
              f"{graph_ms:.1f}, composed modules (f32) {ref_ms:.1f}; graph "
              f"on the CPU (one run) {t_cpu * 1e3:.1f} | {card}", flush=True)
        out[dec_type] = dict(
            parameters=n_params, nodes=n_nodes, bytes=len(data),
            export_s=t_export, load_s=t_load, frames=frames,
            samples=len(got), speed=float(speed), cpu_scaled_max=cpu_err,
            ref_scaled_max=ref_err, ref_int16_max_diff=pcm_diff,
            bf16_rel_l2=bf16_rel, phase2_spread=spread, graph_ms=graph_ms,
            composed_ms=ref_ms, cpu_ms=t_cpu * 1e3, launches=c,
            launches_bf16=c16, probes=probes)
        del engine, model, mods, data
        gc.collect()
        torch.cuda.empty_cache()
    windows["onnx"] = total
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[12 onnx] phase wall {out['wall_s']:.1f} s, launches {total}",
          flush=True)
    return out


EXPORT_DECODERS = ("hifigan", "istftnet", "vocos")
# the loaded graphs against the live engine on the same inputs: phase 1 as
# max |diff| / max |want| per output, phase 2's PCM at phase 6's f32 gate
EXPORT_P1_GATE = 1e-5
EXPORT_PCM_GATE = BATCH_BOUND["float32"]
# what a process that loads the graphs may import of the package: the
# loader, the operator module and what that imports
EXPORT_CHILD_MODULES = {
    "styletts2_tpu_torch", "styletts2_tpu_torch.ops",
    "styletts2_tpu_torch.ops.vocoder_kernel",
    "styletts2_tpu_torch.ops.launch_count", "styletts2_tpu_torch.ops._build",
    "styletts2_tpu_torch.tools", "styletts2_tpu_torch.tools.export_serving"}


def _wait_for(path: Path, timeout: float = 900.0) -> None:
    t0 = time.perf_counter()
    while not path.exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout:.0f} s")
        time.sleep(0.2)


def export_worker(spec_path: str) -> int:
    """Phase 13's serving process (`--export-worker SPEC`): imports torch
    and the operator module only (asserted). For each decoder of the spec,
    as soon as the parent has written its graphs (`ready.json`): loads
    them with `load_exported`, runs phase 1 on the parent's tokens, then
    phase 2 on the parent's post-processed durations (its B1 launches
    counted by ops/launch_count), and writes the outputs. Then calls the
    registered op directly on CUDA against ada_snake_conv_plain at one
    HiFi-GAN shape (phase 3's gates), and last times every decoder's
    loaded graphs (median of 5, synced) while the parent waits."""
    t_start = time.perf_counter()
    spec = json.loads(Path(spec_path).read_text())
    sys.path.insert(0, spec["root"])
    import torch
    from styletts2_tpu_torch.ops import launch_count as LC
    from styletts2_tpu_torch.ops import vocoder_kernel as VK
    from styletts2_tpu_torch.tools.export_serving import load_exported

    torch.set_num_threads(4)
    chk = Checks()
    ws = Path(spec["ws"])
    runs = {}
    for dec in spec["decoders"]:
        _wait_for(ws / dec / "ready.json")
        ready = json.loads((ws / dec / "ready.json").read_text())
        t0 = time.perf_counter()
        _, graphs = load_exported(str(ws / dec))
        load_s = time.perf_counter() - t0
        x = {k: torch.from_numpy(v).cuda()
             for k, v in np.load(ws / dec / "inputs.npz").items()}
        p1, p2 = graphs[ready["p1"]], graphs[ready["p2"]]
        t_en, d, dur = p1(x["tokens"], x["mask"], x["s"])
        LC.reset()
        pcm = p2(t_en, d, x["s"], x["durs"])
        torch.cuda.synchronize()
        b1 = LC.get("ada_snake_conv")
        np.savez(ws / dec / "outputs.npz", t_en=t_en.float().cpu().numpy(),
                 d=d.float().cpu().numpy(), dur=dur.cpu().numpy(),
                 pcm=pcm.cpu().numpy())
        runs[dec] = (p1, p2, x, t_en, d)
        (ws / dec / "result.json").write_text(json.dumps(
            dict(load_s=load_s, b1=b1)))

    # the op itself at HiFi-GAN's first resblock stage at the frame bucket
    # (C 256, T = 2 F x 10), k 3, d 3
    fb = spec["fb"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    op = {}
    for dtype, res, st in ((torch.float32, False, False),
                           (torch.bfloat16, True, True)):
        o = b1_operands(256, 20 * fb, 3, dtype, gen, residual=res)
        got = VK.OP(o["x"], o["scale"], o["shift"], o["alpha"], o["w"],
                    o["bias"], 3, o["n_valid"], o["residual"], st)
        want = b1_call(VK.ada_snake_conv_plain, o, 3, st)
        want = want if st else (want, None)
        name = str(dtype).split(".")[-1]
        err = (got[0].float() - want[0].float()).abs().max().item()
        scale = max(1.0, want[0].float().abs().max().item())
        ok = err <= TOL[name] * scale
        if st:
            serr = ((got[1] - want[1]).abs().max().item()
                    / max(1.0, want[1].abs().max().item()))
            ok = ok and serr <= STATS_TOL[name]
        chk.check(ok, f"registered op on CUDA (1, {20 * fb}, 256) {name} vs "
                  f"plain: err {err:.3g} of max {scale:.3g}")
        op[name] = dict(shape=[1, 20 * fb, 256], max_abs_err=err,
                        max_plain=scale)

    # the dispatcher's host cost per eager call: the op against its CUDA
    # kernel's function called directly (the route before the op), on a
    # shape whose launch takes less device time than either call's host
    # time, in turns
    o = b1_operands(256, 64, 3, torch.bfloat16, gen, residual=True)
    args = (o["x"], o["scale"], o["shift"], o["alpha"], o["w"], o["bias"], 1,
            o["n_valid"], o["residual"], True)
    per_call = {"direct": [], "op": []}
    for name in ("direct", "op", "op", "direct") * 3:
        fn = VK._op_cuda if name == "direct" else VK.OP
        for _ in range(20):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn(*args)
        torch.cuda.synchronize()
        per_call[name].append((time.perf_counter() - t0) / 500 * 1e6)
    op["host_us_per_call"] = {k: float(np.median(v))
                              for k, v in per_call.items()}

    timing = {}
    for dec, (p1, p2, x, t_en, d) in runs.items():
        timing[dec] = dict(
            phase1_ms=_synced_ms(lambda: p1(x["tokens"], x["mask"], x["s"]),
                                 reps=5),
            phase2_ms=_synced_ms(lambda: p2(t_en, d, x["s"], x["durs"]),
                                 reps=5))
    mods = sorted(m for m in sys.modules if m.startswith("styletts2_tpu"))
    extra = sorted(set(mods) - EXPORT_CHILD_MODULES)
    chk.check(not extra and "styletts2_tpu_torch.ops.vocoder_kernel" in mods,
              f"the serving process imported model code: {extra}")
    chk.check(not any(m == "jax" or m.startswith("jax.")
                      for m in sys.modules), "the serving process imported jax")
    (ws / "worker.json").write_text(json.dumps(dict(
        op=op, timing=timing, modules=mods, failed=chk.failed,
        wall_s=time.perf_counter() - t_start)))
    return 0


def phase_export(chk: Checks, root: Path, card: str, windows):
    """Phase 13: per decoder (config_example.yaml's widths, bf16, seeded
    random weights; iSTFTNet and Vocos with phase 8's config edits),
    `export_engine` at the (token, frame) bucket pair the two-phase plan
    takes for the short text with phase 5's style (its durations through
    the engine's host glue, stabilisation on). One process of this script
    that imports torch and the operator module only (`export_worker`,
    started first) loads each decoder's graphs as soon as they are written
    (while the next decoder exports) and runs them on the same inputs:
    held against the live engine's `_phase1` / `_phase2` (bit identity
    reported; EXPORT_P1_GATE, EXPORT_PCM_GATE), B1 launches per phase-2
    call (b1_per_eval), and, once every export is done, the loaded graphs'
    wall ms, then the live eager phases' (each timed while the other
    process waits). Adds the "export" window (the serving process's
    counted phase-2 calls) to `windows`."""
    import torch
    import yaml

    from styletts2_tpu_torch.config import load_config, with_decoder_type
    from styletts2_tpu_torch.infer import StyleTTS2, _bucket
    from styletts2_tpu_torch.text import tokens_for_sentence
    from styletts2_tpu_torch.tools.export_serving import export_engine

    t_phase = time.perf_counter()
    raw = yaml.safe_load((root / "configs" / "config_example.yaml")
                         .read_text())
    ws = root / "build" / "export_smoke"
    shutil.rmtree(ws, ignore_errors=True)
    ws.mkdir(parents=True)
    live, out = {}, {}
    proc = None
    try:
        for dec_type in EXPORT_DECODERS:
            tag = f"[13 export {dec_type}]"
            cfg = load_config(with_decoder_type(raw, dec_type))
            engine = StyleTTS2(cfg, seed=0)
            dev = engine.device
            s = engine.compute_style(style_clip(engine.sr)).reshape(1, -1)
            tk = tokens_for_sentence(TEXTS["short"], engine.cleaner)
            tb = _bucket(cfg.tpu.token_buckets, len(tk))
            tokens = np.zeros((1, tb), np.int64)
            tokens[0, : len(tk)] = tk
            mask = np.zeros((1, tb), bool)
            mask[0, : len(tk)] = True
            tok_d = torch.from_numpy(tokens).to(dev)
            mask_d = torch.from_numpy(mask).to(dev)
            live1 = engine._phase1(tok_d, mask_d, s)
            pred, _ = engine._postprocess_durations(
                live1[2][0, : len(tk)].cpu().numpy(), 1.0, 0.0, 0.2,
                np.random.default_rng([0, 0]))
            durs = np.zeros((1, tb), np.int32)
            durs[0, : len(tk)] = pred
            frames = int(pred.sum())
            fb = _bucket(cfg.tpu.frame_buckets, frames)
            durs_d = torch.from_numpy(durs).to(dev)
            live2 = engine._phase2(*live1[:2], s, durs_d, fb)
            if proc is None:  # its imports overlap the first export
                spec_path = ws / "spec.json"
                spec_path.write_text(json.dumps(dict(
                    root=str(root), ws=str(ws), fb=fb,
                    decoders=list(EXPORT_DECODERS))))
                with open(ws / "worker.log", "w") as logf:
                    proc = subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--export-worker", str(spec_path)],
                        stdout=logf, stderr=subprocess.STDOUT)

            gdir = ws / dec_type
            manifest, export_s = timed(lambda: export_engine(
                engine, str(gdir), [tb], [fb]))
            mb = {f: (gdir / f).stat().st_size / 1e6
                  for f in manifest.values()}
            print(f"{tag} export_engine at (token bucket {tb}, frame "
                  f"bucket {fb}; {len(tk)} tokens, {frames} frames): "
                  f"{export_s:.1f} s, "
                  + ", ".join(f"{f} {v:.1f} MB" for f, v in mb.items())
                  + f" | {card}", flush=True)
            np.savez(gdir / "inputs.npz", tokens=tokens, mask=mask,
                     s=s.float().cpu().numpy(), durs=durs)
            (gdir / "ready.json").write_text(json.dumps(dict(
                p1=f"phase1/{tb}", p2=f"phase2/{tb}/{fb}")))
            live[dec_type] = (engine, tok_d, mask_d, s, durs_d, fb, live1,
                              live2)
            out[dec_type] = dict(token_bucket=tb, frame_bucket=fb,
                                 tokens=len(tk), frames=frames,
                                 export_s=export_s, file_mb=mb)
        proc.wait(timeout=900)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
    chk.check(proc.returncode == 0, f"[13 export] serving process exit "
              f"{proc.returncode}: "
              f"{(ws / 'worker.log').read_text()[-3000:]}")
    worker = (json.loads((ws / "worker.json").read_text())
              if proc.returncode == 0 else {"failed": [], "timing": {}})
    for what in worker["failed"]:
        chk.check(False, f"[13 export] {what}")
    if worker.get("modules"):
        print(f"[13 export] serving process: imports "
              f"{', '.join(m.split('.', 1)[-1] for m in worker['modules'])}"
              f"; its wall {worker['wall_s']:.1f} s (started before the "
              f"first export); registered op on CUDA vs plain: "
              + "; ".join(f"{k} {tuple(v['shape'])} err "
                          f"{v['max_abs_err']:.3g} of max "
                          f"{v['max_plain']:.3g}"
                          for k, v in worker["op"].items()
                          if k != "host_us_per_call"), flush=True)
        hc = worker["op"]["host_us_per_call"]
        print(f"[13 export] eager B1 call (1, 64, 256) bf16, host us per "
              f"call, median of 6 runs of 500: through the op "
              f"{hc['op']:.1f}, the CUDA kernel's function called directly "
              f"{hc['direct']:.1f} | {card}", flush=True)

    total = {"b1": 0, "b2": 0}
    for dec_type, (engine, tok_d, mask_d, s, durs_d, fb, live1,
                   live2) in live.items():
        tag = f"[13 export {dec_type}]"
        gdir = ws / dec_type
        per_eval = b1_per_eval(engine.cfg.model_params.decoder)
        eager1_ms = _synced_ms(lambda: engine._phase1(tok_d, mask_d, s), 5)
        eager2_ms = _synced_ms(lambda: engine._phase2(*live1[:2], s, durs_d,
                                                      fb), 5)
        out[dec_type].update(eager_phase1_ms=eager1_ms,
                             eager_phase2_ms=eager2_ms)
        if not (gdir / "result.json").exists():
            continue
        res = json.loads((gdir / "result.json").read_text())
        got = np.load(gdir / "outputs.npz")
        p1_err = {}
        for name, want in zip(("t_en", "d", "dur"), live1):
            w = want.float().cpu().numpy()
            p1_err[name] = (scaled_max_err(got[name], w)
                            if got[name].shape == w.shape else float("inf"))
        want_pcm = live2.cpu().numpy()
        same = got["pcm"].shape == want_pcm.shape
        pcm_rel = (rel_l2(got["pcm"].astype(np.float64),
                          want_pcm.astype(np.float64)) if same
                   else float("inf"))
        pcm_diff = (int(np.abs(got["pcm"].astype(np.int64)
                               - want_pcm.astype(np.int64)).max())
                    if same else None)
        identical = (same and np.array_equal(got["pcm"], want_pcm)
                     and all(v == 0.0 for v in p1_err.values()))
        chk.check(all(v < EXPORT_P1_GATE for v in p1_err.values()),
                  f"{tag} phase-1 graph vs live _phase1: scaled max "
                  f"{p1_err}")
        chk.check(pcm_rel < EXPORT_PCM_GATE, f"{tag} phase-2 graph vs live "
                  f"_phase2: PCM rel-l2 {pcm_rel:.3g}")
        chk.check(res["b1"] == per_eval, f"{tag} B1 launches per exported "
                  f"phase-2 call {res['b1']} (want {per_eval})")
        total["b1"] += res["b1"]
        tm = worker["timing"].get(dec_type, {})
        print(f"{tag} serving process: load {res['load_s']:.1f} s; vs the "
              f"live engine: phase 1 scaled max "
              + ", ".join(f"{k} {v:.3g}" for k, v in p1_err.items())
              + f", PCM rel-l2 {pcm_rel:.3g}, largest int16 difference "
              f"{pcm_diff}, bit-identical {identical}; B1 {res['b1']} "
              f"launches per phase-2 call (want {per_eval})", flush=True)
        print(f"{tag} wall ms, median of 5 synced: loaded phase 1 "
              f"{tm.get('phase1_ms', float('nan')):.2f}, phase 2 "
              f"{tm.get('phase2_ms', float('nan')):.2f}; live eager _phase1 "
              f"{eager1_ms:.2f}, _phase2 {eager2_ms:.2f} | {card}",
              flush=True)
        out[dec_type].update(
            load_s=res["load_s"], b1=res["b1"], **tm,
            phase1_scaled_max=p1_err, pcm_rel_l2=pcm_rel,
            pcm_int16_max_diff=pcm_diff, bit_identical=identical)
    out["op"] = worker.get("op")
    del live
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ws, ignore_errors=True)
    windows["export"] = total
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[13 export] phase wall {out['wall_s']:.1f} s, launches {total}",
          flush=True)
    return out


# phase 14: bench_train's timed steps at the reference recipe, and the keys
# of its JSON line
BENCH_STEPS = 3
BENCH_KEYS = {"metric", "ms_per_step", "steps_per_s", "mel_frames_per_s",
              "audio_s_per_train_s", "compile_plus_first_step_s", "device",
              "losses", "peak_mem_gib"}
PROFILE_LINES = [r"dispatch overhead: [\d.]+ ms",
                 r"B1 op call \(1, \d+, 256\): [\d.]+ ms",
                 r"phase1 \(b=1, tb=64\): [\d.]+ ms",
                 *(rf"phase2 \(b=1, fb={fb}, [\d.]+s audio\): [\d.]+ ms -> "
                   r"[\d.]+x realtime" for fb in (400, 800, 1600)),
                 r"decoder-only \(b=1, fb=800\): [\d.]+ ms -> [\d.]+x",
                 r"generator-only: [\d.]+ ms -> [\d.]+x",
                 r"f0n-only \(b=1, fb=800\): [\d.]+ ms"]


def _tool_main(main, argv):
    """main(argv) in this process with its standard output captured: (its
    return value, the lines it printed). A tool that fails raises."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    return ret, buf.getvalue().splitlines()


def phase_tools(chk: Checks, card: str, windows):
    """Phase 14: `tools/bench_train` at the reference recipe and
    `tools/profile_inference hifigan 1`, each through its `main` in this
    process, each in a window of the launch counts (set to 0 just before
    the tool, read just after).
    Adds the "tools_bench" and "tools_profile" windows to `windows`."""
    import torch

    from styletts2_tpu_torch.ops import launch_count as LC
    from styletts2_tpu_torch.tools import bench_train as BT
    from styletts2_tpu_torch.tools import profile_inference as PI

    t_phase = time.perf_counter()
    out = {}
    argv = ["--steps", str(BENCH_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    LC.reset()
    t0 = time.perf_counter()
    with KernelProbe() as probe:
        bench, lines = _tool_main(BT.main, argv)
    counts = launches()
    wall = time.perf_counter() - t0
    print(f"[14 tools] bench_train {' '.join(argv)}, its output:", flush=True)
    for line in lines:
        print(f"[14 tools]   {line}", flush=True)
    cfg = BT.bench_config()
    want_b2 = BT.b2_launches(cfg, BENCH_STEPS)
    printed = json.loads(lines[-1]) if lines else None
    chk.check(printed == bench and set(bench) == BENCH_KEYS,
              f"[14 tools] bench_train's JSON line: {lines[-1:]}")
    chk.check(all(np.isfinite(v) for v in bench["losses"].values()),
              f"[14 tools] bench_train losses finite: {bench['losses']}")
    chk.check(counts["b2"] == want_b2 and counts["b1"] == 0,
              f"[14 tools] bench_train launches {counts} (want B2 "
              f"{want_b2} = 8 x ({BENCH_STEPS} + 1) steps, B1 0)")
    print(f"[14 tools] bench_train: {bench['ms_per_step']:.2f} ms/step, "
          f"{bench['mel_frames_per_s']:.1f} mel frames/s, "
          f"{bench['audio_s_per_train_s']:.2f} s audio per s, first step "
          f"{bench['compile_plus_first_step_s']:.1f} s, peak "
          f"{bench['peak_mem_gib']:.2f} GiB; launches B2 {counts['b2']} "
          f"(want {want_b2}), B1 {counts['b1']}; tool wall {wall:.1f} s | "
          f"{card}", flush=True)
    windows["tools_bench"] = counts
    probed = probe.compare(chk, "[14 tools] bench_train")
    print(f"[14 tools] bench_train window: {probe_line(probed)}", flush=True)
    out["bench"] = dict(bench, argv=argv, launches=counts, want_b2=want_b2,
                        wall_s=wall, probe=probed)

    gc.collect()
    torch.cuda.empty_cache()
    LC.reset()
    t0 = time.perf_counter()
    with KernelProbe() as probe:
        prof, lines = _tool_main(PI.main, ["hifigan", "1"])
    counts = launches()
    wall = time.perf_counter() - t0
    print("[14 tools] profile_inference hifigan 1, its output:", flush=True)
    for line in lines:
        print(f"[14 tools]   {line}", flush=True)
    want = [re.escape(card), r"device: .+", *PROFILE_LINES]
    chk.check(len(lines) == len(want) and all(
        re.fullmatch(p, line) for p, line in zip(want, lines)),
        f"[14 tools] profile_inference's lines: {lines}")
    per_eval = b1_per_eval(PI.profile_config("hifigan").model_params.decoder)
    want_b1 = per_eval * prof["evals"] + prof["b1_op_calls"]
    chk.check(counts["b1"] == want_b1 and counts["b2"] > 0,
              f"[14 tools] profile_inference launches {counts} (want B1 "
              f"{want_b1} = {per_eval} x {prof['evals']} evaluations + "
              f"{prof['b1_op_calls']} operator calls, B2 > 0)")
    print(f"[14 tools] profile_inference: phase 1 "
          f"{prof['phase1_s'] * 1e3:.2f} ms; phase 2 "
          + ", ".join(f"fb {fb} {t * 1e3:.2f} ms"
                      for fb, t in prof["phase2_s"].items())
          + f"; decoder {prof['decoder_s'] * 1e3:.2f}, generator "
          f"{prof['generator_s'] * 1e3:.2f}, F0/N {prof['f0n_s'] * 1e3:.2f}"
          f" ms; dispatch {prof['dispatch_s'] * 1e3:.3f}, B1 op "
          f"{prof['b1_op_s'] * 1e3:.3f} ms; launches B1 {counts['b1']} "
          f"(want {want_b1}), B2 {counts['b2']}; tool wall {wall:.1f} s | "
          f"{card}", flush=True)
    windows["tools_profile"] = counts
    probed = probe.compare(chk, "[14 tools] profile_inference")
    print(f"[14 tools] profile_inference window: {probe_line(probed)}",
          flush=True)
    out["profile"] = dict(prof, launches=counts, want_b1=want_b1,
                          wall_s=wall, probe=probed)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[14 tools] phase wall {out['wall_s']:.1f} s", flush=True)
    return out


def scaled_max_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write the measurements here")
    ap.add_argument("--b1-only", action="store_true",
                    help="run phases 1-3 only and print no result line")
    ap.add_argument("--deploy-only", action="store_true",
                    help="run phases 1, 2 and 9 only (with phase 7's "
                    "workspace) and print no result line")
    ap.add_argument("--slm-only", action="store_true",
                    help="run phases 1, 2 and 10 only (on a fresh phase-7 "
                    "workspace) and print no result line")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run phases 1, 2 and 11 only (on a fresh phase-7 "
                    "workspace) and print no result line")
    ap.add_argument("--onnx-only", action="store_true",
                    help="run phases 1, 2 and 12 only and print no result "
                    "line")
    ap.add_argument("--export-only", action="store_true",
                    help="run phases 1, 2 and 13 only and print no result "
                    "line")
    ap.add_argument("--tools-only", action="store_true",
                    help="run phases 1, 2 and 14 only and print no result "
                    "line")
    ap.add_argument("--parallel-worker", metavar="SPEC",
                    help=argparse.SUPPRESS)  # one rank of phase 11
    ap.add_argument("--export-worker", metavar="SPEC",
                    help=argparse.SUPPRESS)  # phase 13's serving process
    ap.add_argument("--package-from", metavar="DIR",
                    help="import styletts2_tpu_torch from the checkout in "
                    "DIR instead of this one (with --b1-only: time another "
                    "commit's kernel with this script's timers)")
    args = ap.parse_args()
    if args.parallel_worker:
        return parallel_worker(args.parallel_worker)
    if args.export_worker:
        return export_worker(args.export_worker)
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
    from styletts2_tpu_torch.profiling import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(8)
    chk = Checks()

    card = card_line()
    print(f"[1 card] {card} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    took = _build.build()
    print(f"[2 build] nvcc {', '.join(f'{k} {v:.1f} s' for k, v in took.items()) or 'up to date'}"
          f"; total {time.perf_counter() - t0:.1f} s", flush=True)

    cfg = load_config(str(root / "configs" / "config_example.yaml"))
    if args.deploy_only:
        cfg_path = train_workspace(root / "build" / "train_smoke",
                                   root / "configs" / "config_example.yaml")
        deploy = phase_deploy(chk, root, card, cfg_path, {})
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "deploy": deploy, "failed": chk.failed},
                indent=1))
        return 1 if chk.failed else 0
    if args.parallel_only:
        par = phase_parallel(chk, root, card, seed_workspace(root), {})
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "parallel": par, "failed": chk.failed},
                indent=1, default=str))
        return 1 if chk.failed else 0
    if args.onnx_only:
        onnx = phase_onnx(chk, root, card, {})
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "onnx": onnx, "failed": chk.failed},
                indent=1, default=str))
        return 1 if chk.failed else 0
    if args.export_only:
        export = phase_export(chk, root, card, {})
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "export": export, "failed": chk.failed},
                indent=1, default=str))
        return 1 if chk.failed else 0
    if args.tools_only:
        tools = phase_tools(chk, card, {})
        print(f"[chip_smoke] wall {time.perf_counter() - T_START:.1f} s",
              flush=True)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "tools": tools, "failed": chk.failed},
                indent=1, default=str))
        return 1 if chk.failed else 0
    if args.slm_only:
        slm = phase_slm(chk, root, card, seed_workspace(root), {})
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "slm": slm, "failed": chk.failed}, indent=1,
                default=str))
        return 1 if chk.failed else 0
    b1 = phase_b1(chk, cfg, frame_bucket=256)
    if args.b1_only:
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(
                {"card": card, "package": str(root), "b1": b1,
                 "failed": chk.failed}, indent=1))
        return 1 if chk.failed else 0
    b2 = phase_b2(chk)
    windows, engine_out = phase_engine(chk, cfg, card)
    phase_f32_vs_cpu(chk, cfg)
    windows["train"], train_out, workload = phase_train(chk, root, card)
    gc.collect()  # phase 7's trainer
    torch.cuda.empty_cache()
    decoders = {}
    for dec_type in DECODER_TYPES:
        decoders[dec_type] = phase_decoder(chk, root, card, dec_type,
                                           workload, windows)
    deploy = phase_deploy(chk, root, card, workload[0], windows)
    gc.collect()
    torch.cuda.empty_cache()
    slm = phase_slm(chk, root, card, workload[0], windows)
    gc.collect()
    torch.cuda.empty_cache()
    par = phase_parallel(chk, root, card, workload[0], windows)
    gc.collect()
    torch.cuda.empty_cache()
    onnx = phase_onnx(chk, root, card, windows, spreads={
        "hifigan": engine_out["batch"]["spread"]["batch8"],
        **{d: decoders[d]["batch"]["spread"]["batch8"]
           for d in DECODER_TYPES}})
    gc.collect()
    torch.cuda.empty_cache()
    export = phase_export(chk, root, card, windows)
    gc.collect()
    torch.cuda.empty_cache()
    tools = phase_tools(chk, card, windows)
    # the main path's launches: every window of phases 5, 7, 8, 9, 10, 11,
    # 12, 13 and 14 (graph replays counted as the launches they recorded;
    # phase 11's per rank; phase 13's in its serving process)
    n_b1 = sum(c["b1"] for c in windows.values())
    n_b2 = sum(c["b2"] for c in windows.values())

    kernels = [
        dict(name="fused_ada_snake_conv", route="cuda",
             source="styletts2_tpu_torch/csrc/vocoder.cu",
             replaces="styletts2_tpu/ops/vocoder_pallas.py:226",
             launches=n_b1, max_abs_err=b1["max_abs_err"], ms=b1["ms"],
             plain_ms=b1["plain_ms"], bound_ms=b1["bound_ms"],
             bound_by=b1["bound_by"], library_ms=None,
             device_ms=b1["device_ms"], device_cold_l2_ms=b1["cold_ms"],
             launches_by_path={k: c["b1"] for k, c in windows.items()},
             istftnet_phase2={k: v for k, v in decoders["istftnet"]["b1"]
                              .items() if k != "detail"}),
        dict(name="fused_log_mel", route="cuda",
             source="styletts2_tpu_torch/csrc/mel.cu",
             replaces="styletts2_tpu/ops/mel_pallas.py:82",
             launches=n_b2, max_abs_err=b2["max_abs_err"], ms=b2["ms"],
             plain_ms=b2["plain_ms"], bound_ms=b2["bound_ms"],
             bound_by=b2["bound_by"], library_ms=None,
             device_ms=b2["device_ms"],
             launches_by_path={k: c["b2"] for k, c in windows.items()},
             training_shapes=train_out["b2_shapes"]),
    ]
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "kernels": kernels, "b1": b1, "b2": b2,
             "engine": engine_out, "launches": windows,
             "train": train_out, "decoders": decoders, "deploy": deploy,
             "slm": slm, "parallel": par, "onnx": onnx, "export": export,
             "tools": tools, "failed": chk.failed}, indent=1,
            default=str))
    print(f"[chip_smoke] wall {time.perf_counter() - T_START:.1f} s",
          flush=True)
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
