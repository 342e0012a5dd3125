"""The process's one count of kernel launches, by kernel wrapper name.

Two sources feed it:
* a kernel wrapper calls `add(name)` where it launches its kernel;
* a CUDA-graph replay calls `add_recorded(graph_launches)` with the
  launches its capture recorded (a replay runs no wrapper).

A capture enqueues work that does not run: inside `recording()` a
thread's `add` calls go into the capture's own dict and not into the
count. Recording is per thread, so a graph captured on one thread never
takes in the launches another thread makes meanwhile (the engine's
background capture runs while the serving thread launches the same
kernels eagerly). The count itself is updated under a lock.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Mapping

_lock = threading.Lock()
_counts: Dict[str, int] = {}
_local = threading.local()


def add(name: str, n: int = 1) -> None:
    """`n` launches of kernel `name` by the calling thread: into its
    open recording, else into the count."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        rec[name] = rec.get(name, 0) + n
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def add_recorded(launches: Mapping[str, int]) -> None:
    """A replay of a graph whose capture recorded `launches`."""
    for name, n in launches.items():
        add(name, n)


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Collect the calling thread's launches in the yielded dict instead of
    the count (a capture: what the graph will launch per replay)."""
    prev = getattr(_local, "recording", None)
    rec: Dict[str, int] = {}
    _local.recording = rec
    try:
        yield rec
    finally:
        _local.recording = prev


def get(name: str) -> int:
    with _lock:
        return _counts.get(name, 0)


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()
