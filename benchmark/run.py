"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU. Set-up
makes the weights, the voice and the traffic from --seed and warms up the
cell's own shapes; the window then runs for --seconds; --trace 1 adds a
profiled slice after it and reports the per-layer metrics instead of the
end-to-end ones. Then the outputs sampled from the window are held
against the plain reference (benchmark/reference/): the numbers compared
and their limits are the last lines of standard error and the `checks`
of the result, the last line of standard output.

Exits 2, printing no result, without a CUDA device; 3 if jax, jaxlib,
flax or styletts2_tpu was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "styletts2_tpu"}


def banned_modules():
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--id=0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return res.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e!r}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import cells

    cell = cells.load(ROOT, args.workload)
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    out = cells.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    found = banned_modules()
    if found:
        print(f"run.py: the process loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(out["info"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
