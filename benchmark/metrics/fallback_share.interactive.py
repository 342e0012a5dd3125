"""Share of the window's requests the fused graph did not serve: the
engine ran a two-phase phase-2 call for them (its `phase2_calls` counter
moved during the request), after a frame total that overflowed the
bucket, a cold pair or a text past the largest bucket. %."""


def read(ctx):
    if not ctx.records:
        return None
    return 100.0 * sum(r.fallback for r in ctx.records) / len(ctx.records)
