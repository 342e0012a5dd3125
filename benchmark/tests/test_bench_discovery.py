"""A configuration, a traffic mix and a per-layer metric are added by
new files and BENCHMARK.json entries alone: the harness finds each by
its name."""

import json
import time

import pytest

from benchmark.harness import cells
from conftest import make_root


def test_added_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path, [("tiny.interactive", "hifigan",
                                 "tiny_interactive")])
    # a new per-layer metric: one file and one entry
    (root / "benchmark" / "metrics" / "requests_seen.interactive.py"
     ).write_text("def read(ctx):\n    return float(len(ctx.records))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "requests_seen.interactive", "unit": "requests",
        "better": "higher", "source": "program_counter",
        "layer": "engine host path", "moves": "latency_p95_ms",
        "workloads": ["tiny.interactive"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load(root, "tiny.interactive")
    assert cell.config["name"] == "tiny-hifigan"
    assert cell.mix["kind"] == "generate" and cell.mix["words"] == [4, 6]
    assert "requests_seen.interactive" in cell.readers
    assert {m["name"] for m in cell.end_to_end} == {
        "latency_p50_ms", "latency_p95_ms", "setup_s"}
    ns = type("ctx", (), {"records": [1, 2, 3]})
    assert cell.readers["requests_seen.interactive"](ns) == 3.0
    # a reader of a cell that does not list it is not loaded
    assert "b1_roofline.serve" not in cell.readers


def test_the_benchmarks_own_cells_load():
    from conftest import ROOT

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for wl in bench["workloads"]:
        cell = cells.load(ROOT, wl["name"])
        assert set(cell.limits) == {"style_gap", "length_mismatch",
                                    "pcm_rms_err"}
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("workload,mix,found", [
    ("tiny.interactive", "tiny_interactive",
     {"fallback_share.interactive", "mfu.interactive",
      "idle_share.interactive"}),
    ("tiny.serve", "tiny_serve",
     {"phase2_calls_per_batch.serve", "mfu.serve", "idle_share.serve"}),
])
def test_a_traced_run_leaves_out_what_finds_nothing(tmp_path, workload, mix,
                                                    found):
    """--trace 1 on the CPU: the per-layer metrics replace the end-to-end
    ones; the readers of device kernels (B1, the recurrences) find no
    device operation in the trace and their metrics are left out."""
    root = make_root(tmp_path, [(workload, "hifigan", mix)])
    out = cells.run_cell(cells.load(root, workload), 2 ** 31 + 5, 0.5, True,
                         "cpu", time.perf_counter())
    assert set(out["metrics"]) == found
    mfu = next(k for k in found if k.startswith("mfu"))
    assert 0 < out["metrics"][mfu]["value"] < 100
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks"
