"""Reduction of a torch.profiler trace of the traced window to what the
per-layer metrics and the breakdown read: the device's busy time (the
union of its operations' intervals), its operations by name, and its idle
gaps by what the host was doing meanwhile.

The window is the harness's "bench.window" span; only device operations
(kernels, copies, sets, including those a CUDA-graph replay launches)
inside it count.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "bench.window"
# idle gaps attributed one by one, longest first
LABELLED = 256


@dataclass
class Trace:
    window_s: float
    busy_s: float
    # device operations in start order: (name, start s, seconds), times
    # from the window's start
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    # idle gaps: (what the host was doing, seconds)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, _, dur in self.ops:
            out[name] = out.get(name, 0.0) + dur
        return out

    def top_ops(self, n: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.seconds_by_name().items(),
                                          key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        out: Dict[str, float] = {}
        for name, dur in self.gaps:
            out[name] = out.get(name, 0.0) + dur
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:n]]


def reduce(prof) -> Trace:
    """A finished torch.profiler.profile -> Trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    win = None
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.name().startswith("bench."):
            # the harness's spans; on the device side they are
            # annotations, not operations
            if e.name() == WINDOW and e.device_type() != cuda:
                win = (start, start + dur)
            elif e.device_type() != cuda:
                host.append((start, start + dur, e.name()))
        elif e.device_type() == cuda:
            dev.append((start, start + dur, e.name()))
        else:
            host.append((start, start + dur, e.name()))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = win
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in dev
                 if b > w0 and a < w1)
    busy = 0
    gaps_ns: List[Tuple[int, int]] = []
    cur = w0
    for a, b, _ in dev:
        if a > cur:
            gaps_ns.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if cur < w1:
        gaps_ns.append((cur, w1))
    # the LONGEST gaps (most of the idle time) by the host operation that
    # covers a gap's midpoint and is the shortest such (the innermost),
    # else the harness span around it; the rest together
    host = sorted(h for h in host if h[1] > w0 and h[0] < w1)
    spans = [h for h in host if h[2].startswith("bench.")]
    starts = [h[0] for h in host]
    gaps_ns.sort(key=lambda g: g[0] - g[1])
    gaps = []
    for a, b in gaps_ns[:LABELLED]:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for s, e, name in host[max(0, i - 2048): i] + spans:
            if s <= mid <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        gaps.append((best[2] if best else "python", (b - a) * 1e-9))
    rest = sum(b - a for a, b in gaps_ns[LABELLED:])
    if rest:
        gaps.append((f"gaps shorter than the {LABELLED} longest", rest * 1e-9))
    return Trace(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                 ops=[(n, (a - w0) * 1e-9, (b - a) * 1e-9) for a, b, n in dev],
                 gaps=gaps)
