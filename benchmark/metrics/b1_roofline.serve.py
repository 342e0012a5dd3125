"""Kernel B1's share of its roofline in the traced slice: the least time
its launches need at the valid frames the batches' texts had (the
yardstick's bound over the 96 launch shapes of a phase-2 row, weights
read once per phase-2 call), over the device time of B1's kernels and
their statistics reduction in the trace. %."""

from benchmark.harness.kernels import b1_seconds


def read(ctx):
    if ctx.trace is None or not ctx.trace_records:
        return None
    dev = b1_seconds(ctx.trace)
    if dev <= 0:
        return None
    # a text's frames summed over its chunks: the bound is linear in
    # frames but for the weights, read once per phase-2 call
    bound_ms = ctx.yardstick.b1_bound_rows(
        ctx.mp["decoder"], [r.frames for r in ctx.trace_records],
        ctx.trace_counters["phase2_calls"])
    return 100.0 * bound_ms * 1e-3 / dev
