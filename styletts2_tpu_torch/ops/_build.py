"""nvcc build and ctypes loader for the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own
into `build/styletts2_tpu_torch/lib<name>-<hash>.so` at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o lib<name>-<hash>.so csrc/<name>.cu

The hash covers the source, every header in `csrc/` (the sources include
`ptx.cuh`) and the flags, so an edited source or header rebuilds and a
stale library is never loaded. `build()` starts one nvcc per missing
library, all at once, and waits for all of them. Nothing here runs at
import time: the CPU tests import every module of the package on a host
that has no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "styletts2_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = {"vocoder": "vocoder.cu", "mel": "mel.cu"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of each library's exported functions: name -> (restype,
# argtypes). Every pointer and the stream are c_void_p: without argtypes
# ctypes passes a Python int as a 32-bit int and cuts the pointer.
SIGNATURES = {
    "vocoder": {
        "ada_snake_conv": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _P]),
        "ada_snake_conv_rows_per_block": (_I, [_I, _I]),
    },
    "mel": {
        "log_mel": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                         _P]),
    },
}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc or
    the one on PATH. Raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise FileNotFoundError("nvcc not found: the CUDA kernels of "
                            "styletts2_tpu_torch need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where library `name` is built: the file name carries a hash of its
    source, of every header in csrc/ (by name and content) and of the
    nvcc flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")) + sorted(CSRC.glob("*.h")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library of `names` (default: all) in parallel.

    Returns {name: seconds} for the libraries built by this call (empty
    when all were up to date). Raises RuntimeError with nvcc's output when
    a build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took: Dict[str, float] = {}
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {SOURCES[n]} failed ({proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library `name`, with every exported
    function's restype and argtypes declared. Thread-safe: the first call
    may come from the serving thread and the engine's capture thread at
    once, and both would write the same temporary file."""
    with _LOAD_LOCK:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn_name, (restype, argtypes) in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
