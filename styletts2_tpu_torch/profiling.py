"""Step timing and non-finite loss detection for the trainer.

The port's own copy of styletts2_tpu/profiling.py's `StepTimer` and
`check_finite`, without the latter's 'skip' action: the check runs after
the step has applied its updates. The JAX profiler trace has no
counterpart here: use torch.profiler, as chip_smoke.py does.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

import numpy as np


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
