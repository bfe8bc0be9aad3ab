"""Device milliseconds a step in GEMM kernels (cuBLAS; names with gemm,
gemv, nvjet, cutlass or sm90_xmma) in the traced steps."""


def read(ctx):
    t = ctx.traced
    if t is None:
        return None
    return 1e3 * t["trace"].seconds_by_class()["matmul"] / t["steps"]
