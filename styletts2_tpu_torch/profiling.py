"""Step timing, a profiler trace of a window of steps, and non-finite loss
detection for the trainer, and the card line that measurements are
printed beside.

The port's own copy of styletts2_tpu/profiling.py's `StepTimer` and
`check_finite`, without the latter's 'skip' action: the check runs after
the step has applied its updates. `StepTrace` takes the place of its
jax.profiler `trace`: a torch.profiler trace of the same steps.
"""

from __future__ import annotations

import os
import subprocess
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch


def card_line(index: int = 0) -> str:
    """GPU `index`'s name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (the
    device's name alone where nvidia-smi gives nothing)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if res.returncode == 0 and res.stdout.strip():
            return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(index)


class StepTrace:
    """A torch.profiler trace (host and, on CUDA, device activity) of the
    steps first <= i < stop of one epoch, written under `logdir` as the
    Chrome trace `steps_{first}-{last}.json` when the window closes (or at
    `close`, when the epoch ends inside it). `begin(i)` / `end(i)` go
    around step i."""

    def __init__(self, logdir: str, device, first: int = 10, stop: int = 15):
        self.logdir, self.first, self.stop = logdir, first, stop
        self.cuda = torch.device(device).type == "cuda"
        self._prof = None
        self._last = None
        self.path: Optional[str] = None

    def begin(self, i: int) -> None:
        if i != self.first or self.path is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def end(self, i: int) -> None:
        if self._prof is None:
            return
        self._last = i
        if i + 1 == self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        self.path = os.path.join(self.logdir,
                                 f"steps_{self.first}-{self._last}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None


class StepTimer:
    def __init__(self, window: int = 50):
        self._times = deque(maxlen=window)
        self._last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self._times.append(dt)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self._times)) if self._times else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


class NonFiniteLossError(RuntimeError):
    pass


def check_finite(metrics: Dict[str, float], step: int,
                 action: str = "raise") -> None:
    """Raise NonFiniteLossError on non-finite losses (action 'raise');
    'ignore' lets them pass. The check runs after the step's updates, so
    there is no update left to skip."""
    bad = sorted(k for k, v in metrics.items() if not np.isfinite(float(v)))
    if bad and action == "raise":
        raise NonFiniteLossError(f"non-finite losses at step {step}: {bad}")
