"""Kernel B1's share of its roofline in the traced slice: the least time
its launches need at the valid frames of each request (the yardstick's
bound over the 96 launch shapes of its one phase-2 row, weights read once
per request), over the device time of B1's kernels and their statistics
reduction in the trace. %."""

from benchmark.harness.kernels import b1_seconds


def read(ctx):
    if ctx.trace is None or not ctx.trace_records:
        return None
    dev = b1_seconds(ctx.trace)
    if dev <= 0:
        return None
    dec = ctx.mp["decoder"]
    bound_ms = sum(ctx.yardstick.b1_bound_rows(dec, [r.frames], 1)
                   for r in ctx.trace_records)
    return 100.0 * bound_ms * 1e-3 / dev
