"""Eager phase-2 calls per batch of the window: the engine's
`phase2_calls` counter over the window's batches. Calls."""


def read(ctx):
    n = ctx.counters.get("batches", 0)
    return ctx.counters["phase2_calls"] / n if n else None
