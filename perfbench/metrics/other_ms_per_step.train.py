"""Device milliseconds a step in every kernel that is neither attention
nor a GEMM (norms, RoPE, modulation, casts, the optimizer, the EMA,
copies) in the traced steps."""


def read(ctx):
    t = ctx.traced
    if t is None:
        return None
    return 1e3 * t["trace"].seconds_by_class()["other"] / t["steps"]
