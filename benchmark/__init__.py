"""The benchmark of styletts2_tpu_torch: one cell of BENCHMARK.json per run
(`python3 benchmark/run.py --workload <name> ...`). See README.md."""
