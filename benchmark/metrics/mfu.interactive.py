"""The whole model's share of the card's peak over the measured window:
the least time the window's FLOPs need (the yardstick's count per valid
token and frame of every request completed, float32 parts at the float32
peak and the bf16 decoder at the bf16 peak) over the window. %."""


def read(ctx):
    if not ctx.records or ctx.window_s <= 0:
        return None
    least = sum(ctx.yardstick.least_seconds(ctx.mp, r.tokens, r.frames)
                for r in ctx.records)
    return 100.0 * least / ctx.window_s
