"""One run of one cell: set-up, the measured window, the traced slice and
the check against the reference.

Everything a cell is made of is found by name: BENCHMARK.json's workload
names its configuration (configs/<config>.json, and BENCHMARK.json's
entry for it) and its traffic mix (traffic/<traffic>.json, whose `kind`
picks the entry point it drives); its limits are limits/<workload>.json,
and each per-layer metric is metrics/<metric>.py, a `read(ctx)` that
returns a number or None when it finds nothing to read.

The measured window opens when set-up ends and runs requests (kind
"generate": one text per `StyleTTS2.generate` call, back to back) or
batches (kind "serve": `StyleTTS2.serve` over an endless stream of
batches, already running) until `seconds` have passed; the request or
batch that crosses the mark is the last, and the window ends when it
completes. A traced run then traces a further slice of the same traffic.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import trace as TR
from benchmark.harness import yardstick as Y
from benchmark.harness.traffic import Texts, alphabet, voice_clip
from benchmark.reference import frontend as FE
from benchmark.reference import params as P
from benchmark.reference import synth as S
from benchmark.reference.model import Reference

# the engine's fused-path frame bucket for a single chunk (infer.py
# `_generate_fused`): the bucket of ceil(tokens x the observed frames per
# token x HEADROOM); set-up captures every pair the window's texts can
# reach at the rates its warm-up saw, widened by RATE_MARGIN
HEADROOM = 1.35
RATE_MARGIN = 1.1


def sub_seed(seed: int, name: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    words = [seed & (2 ** 64 - 1)] + [ord(c) for c in name]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


@dataclass
class Cell:
    workload: Dict[str, Any]
    config: Dict[str, Any]          # configs/<name>.json
    mix: Dict[str, Any]             # traffic/<name>.json
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, Callable] = field(default_factory=dict)

    @property
    def cfg(self) -> Dict[str, Any]:
        return self.config["config"]


def load(root: Path, name: str) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    here = root / bench["paths"][0]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((here / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    cell = Cell(wl, config, mix, limits, mine(bench["end_to_end"]),
                mine(bench["per_layer"]))
    for m in cell.per_layer:
        path = here / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{len(cell.readers)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cell.readers[m["name"]] = mod.read
    return cell


@dataclass
class Request:
    """One text served: its tokens and frames summed over its chunks."""
    tokens: int
    frames: int
    audio_s: float
    latency_s: Optional[float] = None
    fallback: bool = False


class Run:
    """Set-up, window, traced slice and check of one cell on `device`."""

    def __init__(self, cell: Cell, seed: int, device, t_start: float):
        self.cell, self.seed, self.t_start = cell, seed, t_start
        self.device = torch.device(device)
        self.cfg = cell.cfg
        self.mp = self.cfg["model_params"]
        self.sr = self.cfg["preprocess_params"]["sr"]
        self.hop2 = 2 * self.cfg["preprocess_params"]["spect_params"][
            "hop_length"]
        self.symbols = FE.symbol_dict(self.cfg["symbol"])
        self.letters = alphabet(self.cfg["symbol"])
        self.draws = 0            # engine seeds drawn: one per synthesis
        self.engine = None
        self.marks: Dict[str, float] = {}
        self._last_mark = t_start

    def mark(self, name: str) -> None:
        """Seconds since the last mark, under `name`."""
        now = time.perf_counter()
        self.marks[name] = now - self._last_mark
        self._last_mark = now

    # ---------------------------------------------------------- helpers

    def texts(self, use: str) -> Texts:
        return Texts(self.cell.mix, self.letters, sub_seed(self.seed, use))

    def chunks(self, text: str) -> List[str]:
        return FE.split_into_chunks(text, self.cell.mix["n_merge"])

    def request(self, text: str, wav: np.ndarray) -> Request:
        """A served text's sizes; its frames from the waveform's length
        (each chunk's middle between one pair of 4000-sample edges)."""
        ch = self.chunks(text)
        toks = sum(len(FE.tokens(c, self.symbols)) for c in ch)
        frames = (len(wav) - 2 * S.EDGE + 2 * S.EDGE * len(ch)) // self.hop2
        return Request(toks, frames, len(wav) / self.sr)

    def duration_scale(self, ref: Reference, s) -> float:
        """The scale that brings the reference's duration head output,
        averaged over 8 or more calibration chunks of the mix, to the mix's
        frames per token."""
        cal, raws = self.texts("calibration"), []
        while len(raws) < 8:
            for c in self.chunks(cal.text()):
                raws.append(ref.phase1(FE.tokens(c, self.symbols), s)[2])
        return (self.cell.mix["frames_per_token"]
                / float(np.concatenate(raws).mean()))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------- set-up

    def setup(self) -> None:
        from styletts2_tpu_torch.config import load_config
        from styletts2_tpu_torch.infer import StyleTTS2

        mix = self.cell.mix
        self.mark("imports")
        sp = P.spec(self.mp, len(self.symbols) + 1)
        weights = P.make_weights(sp, sub_seed(self.seed, "weights"),
                                 self.device)
        self.tree = P.host_tree(weights)
        self.mark("weights")
        self.engine_seed = sub_seed(self.seed, "engine")
        eng = StyleTTS2(load_config(copy.deepcopy(self.cfg)),
                        params=self.tree, seed=self.engine_seed,
                        device=self.device)
        self.engine = eng
        self.mark("engine")
        clip = voice_clip(sub_seed(self.seed, "voice"), self.sr)
        self.style_prog = eng.compute_style(clip).reshape(-1).float()
        ref = Reference(self.cfg, weights, self.device)
        self.s_ref = ref.style(clip)
        self.scale = self.duration_scale(ref, self.s_ref)
        self.mark("style_and_calibration")
        del ref, weights
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        eng.duration_scale = self.scale
        self.style = {"style": self.style_prog[None], "speed": mix["speed"]}
        self.stabilize = mix["stabilize"]

    # ---------------------------------------------------------- drive

    def generate(self, text: str):
        eng = self.engine
        p2 = eng.phase2_calls
        t0 = time.perf_counter()
        wav = eng.generate(text, self.style, stabilize=self.stabilize,
                           n_merge=self.cell.mix["n_merge"])
        t1 = time.perf_counter()
        self.draws += 1
        r = self.request(text, wav)
        r.latency_s, r.fallback = t1 - t0, eng.phase2_calls > p2
        return wav, r, t1

    def warm_generate(self, window_texts: List[str]) -> None:
        """The warm-up stream, then a graph for every (token bucket, frame
        bucket) pair the window's texts reach at the warm-up's rates, then
        the stream again so the engine's rate estimate is its own."""
        eng, mix = self.engine, self.cell.mix
        warm = self.texts("warm-up")
        rates = []
        for _ in range(mix["warmup_requests"]):
            _, r, _ = self.generate(warm.text())
            rates.append(r.frames / r.tokens)
        lo, hi = min(rates) / RATE_MARGIN, max(rates) * RATE_MARGIN
        tbs, fbs = eng.cfg.tpu.token_buckets, eng.cfg.tpu.frame_buckets

        def bucket(bs, n):
            return next((b for b in bs if b >= n), None)

        pairs = set()
        for n in {len(FE.tokens(t, self.symbols)) for t in window_texts}:
            tb = bucket(tbs, n)
            f_lo = bucket(fbs, math.ceil(n * lo * HEADROOM))
            f_hi = bucket(fbs, math.ceil(n * hi * HEADROOM)) or fbs[-1]
            if tb is None or f_lo is None:
                continue
            pairs.update((tb, fb) for fb in fbs if f_lo <= fb <= f_hi)
        self.captured = 0
        if self.device.type != "cuda":
            pairs = set()  # no graphs: the CPU engine runs the fused path eagerly
        for tb, fb in sorted(pairs - set(eng.graphs)):
            n, f = self._fixed_request(tbs, fbs, tb, fb)
            if n is None:
                continue
            word = "".join(self.letters[i % len(self.letters)]
                           for i in range(n - 2))
            eng.fixed_duration = f
            try:
                eng.generate(word, self.style, stabilize=self.stabilize)
                self.draws += 1
            finally:
                eng.fixed_duration = None
            self.captured += 1
        for _ in range(mix["settle_requests"]):
            self.generate(warm.text())

    @staticmethod
    def _fixed_request(tbs, fbs, tb, fb):
        """(tokens, fixed frames per token) whose fused call lands on
        (tb, fb), or (None, None)."""
        tb0 = max([b for b in tbs if b < tb], default=2)
        fb0 = max([b for b in fbs if b < fb], default=0)
        for f in range(1, 64):
            for n in range(max(tb0 + 1, 3), tb + 1):
                if fb0 < f * n <= fb:
                    return n, f
        return None, None

    def window_generate(self, seconds: float, sample_p: float):
        """Requests back to back until `seconds` have passed."""
        mix = self.cell.mix
        texts = self.texts("window")
        planned = [texts.text() for _ in range(mix["plan_requests"])]
        self.warm_generate(planned)

        def stream():
            yield from planned
            while True:
                yield texts.text()

        self.sync()
        self.mark("warm_up")
        keep_rng = np.random.default_rng(sub_seed(self.seed, "keep"))
        self.kept: Dict[int, tuple] = {}
        longest = None
        recs: List[Request] = []
        c0 = self.counters()
        graphs0 = len(self.engine.graphs)
        t_open = time.perf_counter()
        self.setup_s = t_open - self.t_start
        for k, text in enumerate(stream()):
            draw = self.draws
            wav, r, t_end = self.generate(text)
            recs.append(r)
            item = (text, draw, 0, wav)
            if keep_rng.random() < sample_p:
                self.kept[k] = item
            if longest is None or r.tokens > longest[1]:
                longest = (k, r.tokens, item)
            if t_end - t_open >= seconds:
                break
        self.window_s = t_end - t_open
        self.kept[longest[0]] = longest[2]
        self.longest = longest[0]
        self.records = recs
        self.window_counters = self.counters(c0)
        self.window_counters["captures"] = len(self.engine.graphs) - graphs0
        self.trace_texts = [texts.text() for _ in range(mix["trace_requests"])]

    def trace_generate(self):
        recs = []
        c0 = self.counters()
        with profiler(self.device) as prof:
            with torch.profiler.record_function(TR.WINDOW):
                for text in self.trace_texts:
                    with torch.profiler.record_function("bench.request"):
                        recs.append(self.generate(text)[1])
                self.sync()
        return prof, recs, self.counters(c0)

    def window_serve(self, seconds: float, sample_p: float):
        """`serve` over an endless stream of batches: warm-up batches, then
        batches until `seconds` have passed."""
        mix = self.cell.mix
        texts = self.texts("window")
        sent: List[List[str]] = []

        def batches():
            while True:
                b = [texts.text() for _ in range(mix["batch"])]
                sent.append(b)
                yield b

        eng = self.engine
        self.stream = eng.serve(batches(), self.style,
                                stabilize=self.stabilize,
                                n_merge=mix["n_merge"])
        draw0 = self.draws
        for _ in range(mix["warmup_batches"]):
            next(self.stream)
        self.sync()
        self.mark("warm_up")
        keep_rng = np.random.default_rng(sub_seed(self.seed, "keep"))
        self.kept = {}
        longest = None
        recs: List[Request] = []
        c0 = self.counters()
        graphs0 = len(eng.graphs)
        t_open = time.perf_counter()
        self.setup_s = t_open - self.t_start
        j = mix["warmup_batches"]
        n_batches = 0
        while True:
            wavs = next(self.stream)
            t_end = time.perf_counter()
            for i, (text, wav) in enumerate(zip(sent[j], wavs)):
                r = self.request(text, wav)
                recs.append(r)
                item = (text, draw0 + j, i, wav)
                if keep_rng.random() < sample_p:
                    self.kept[len(recs) - 1] = item
                if longest is None or r.tokens > longest[1]:
                    longest = (len(recs) - 1, r.tokens, item)
            j += 1
            n_batches += 1
            if t_end - t_open >= seconds:
                break
        self.window_s = t_end - t_open
        self.kept[longest[0]] = longest[2]
        self.longest = longest[0]
        self.records = recs
        self.window_counters = self.counters(c0)
        self.window_counters["batches"] = n_batches
        self.window_counters["captures"] = len(eng.graphs) - graphs0
        self._sent, self._j, self._draw0 = sent, j, draw0
        self.draws = draw0 + len(sent)

    def trace_serve(self):
        recs = []
        c0 = self.counters()
        with profiler(self.device) as prof:
            with torch.profiler.record_function(TR.WINDOW):
                for _ in range(self.cell.mix["trace_batches"]):
                    with torch.profiler.record_function("bench.batch"):
                        wavs = next(self.stream)
                    recs += [self.request(t, w)
                             for t, w in zip(self._sent[self._j], wavs)]
                    self._j += 1
        self.draws = self._draw0 + len(self._sent)
        c = self.counters(c0)
        c["batches"] = self.cell.mix["trace_batches"]
        return prof, recs, c

    def counters(self, since: Optional[Dict[str, int]] = None):
        now = {"phase2_calls": self.engine.phase2_calls,
               "graph_replays": self.engine.graph_replays}
        if since is None:
            return now
        return {k: now[k] - since[k] for k in now}

    # ---------------------------------------------------------- check

    def check(self) -> Dict[str, float]:
        """The numbers compared: the style's relative gap, the largest RMS
        audio error of the sampled texts (full scale 1) and the count whose
        length differs."""
        ref = Reference(self.cfg, P.to_device(self.tree, self.device),
                        self.device)
        s = self.s_ref
        gap_style = float(torch.linalg.vector_norm(
            self.style_prog.to(self.device) - s) / torch.linalg.vector_norm(s))
        keys = sorted(k for k in self.kept if k != self.longest)
        rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        n = self.cell.mix["sample"] - 1
        pick = list(rng.choice(keys, size=min(n, len(keys)), replace=False))
        pick.append(self.longest)
        seeds = S.base_seeds(self.engine_seed, self.draws)
        errs, mismatch, self.verdicts = [], 0, []
        for k in pick:
            text, draw, chain, wav = self.kept[k]
            chunks = S.plan_text(ref, text, s, self.scale, seeds[draw], chain,
                                 self.cell.mix["n_merge"],
                                 t=0.2 if self.stabilize else 0.0,
                                 speed=self.cell.mix["speed"])
            v = S.compare(ref, chunks, s, wav)
            self.verdicts.append(v)
            mismatch += int(not v.length_ok)
            errs.append(v.err_rms)
        return {"style_gap": gap_style, "pcm_rms_err": max(errs),
                "length_mismatch": float(mismatch),
                "sampled": float(len(pick))}

    # ---------------------------------------------------------- whole run

    def close(self) -> None:
        stream = getattr(self, "stream", None)
        if stream is not None:
            stream.close()
            self.stream = None
        self.sync()
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def profiler(device):
    """torch.profiler over host and (on CUDA) device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float) -> Dict[str, Any]:
    """One run of `cell`: the result line's object."""
    kind = cell.mix["kind"]
    run = Run(cell, seed, device, t_start)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup()
    failed = 0
    if kind == "generate":
        run.window_generate(seconds, cell.mix["keep_share"])
        traced_part = run.trace_generate() if traced else None
    elif kind == "serve":
        run.window_serve(seconds, cell.mix["keep_share"])
        traced_part = run.trace_serve() if traced else None
    else:
        raise SystemExit(f"unknown traffic kind {kind!r}")
    run.sync()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    ctx = SimpleNamespace(
        kind=kind, mp=run.mp, window_s=run.window_s, records=run.records,
        counters=run.window_counters, trace=None, trace_records=None,
        trace_counters=None, yardstick=Y)
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced_part is not None:
        prof, recs, counters = traced_part
        tr = TR.reduce(prof)
        ctx.trace, ctx.trace_records, ctx.trace_counters = tr, recs, counters
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_gaps()}
    run.close()

    metrics: Dict[str, Dict[str, Any]] = {}
    if traced:
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = end_to_end(ctx, run.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    t_check = time.perf_counter()
    numbers = run.check()
    run.marks["check"] = time.perf_counter() - t_check
    limits = cell.limits
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = (failed == 0 and len(run.records) > 0
               and all(v["value"] <= v["limit"] for v in checks.values()))
    out = {"correct": bool(correct), "attempted": len(run.records),
           "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["info"] = {
        "seed": seed, "window_s": run.window_s, "setup_s": run.setup_s,
        "duration_scale": run.scale, "draws": run.draws,
        "sampled": numbers["sampled"], "marks_s": run.marks,
        "counters": run.window_counters,
        "graphs_captured_by_fixed_durations": getattr(run, "captured", 0),
        "frames_per_token": (sum(r.frames for r in run.records)
                             / max(1, sum(r.tokens for r in run.records))),
        "tokens_mean": float(np.mean([r.tokens for r in run.records])),
        "latency_mean_ms": (float(np.mean([r.latency_s for r in run.records]))
                            * 1e3 if kind == "generate" else None),
        "ref_rms": [v.rms for v in run.verdicts],
        "ref_dc": [v.dc for v in run.verdicts],
        "ref_clipped": [v.clipped for v in run.verdicts],
        "gaps": [v.gap for v in run.verdicts],
        "rms_errs": [v.err_rms for v in run.verdicts],
    }
    out["checks"] = checks
    return out


def end_to_end(ctx, setup_s: float) -> Dict[str, float]:
    recs = ctx.records
    out = {"setup_s": setup_s}
    lat = [r.latency_s for r in recs if r.latency_s is not None]
    if lat:
        out["latency_p50_ms"] = float(np.percentile(lat, 50) * 1e3)
        out["latency_p95_ms"] = float(np.percentile(lat, 95) * 1e3)
    out["audio_s_per_s"] = sum(r.audio_s for r in recs) / ctx.window_s
    return out
