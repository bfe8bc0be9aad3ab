"""The attention kernels' share of their bound in the traced steps: the
sum of each launch's bound (perfbench/flops.py ``attention_bounds``)
over the device seconds of the kernels of ops/splash.py, ops/band.py,
ops/band2.py and ops/doc_tiles.py; in %. Nothing is read where the
program's launch counters disagree with the launches the bound
counts."""


def read(ctx):
    t = ctx.traced
    if t is None or t["launches"] != t["launches_expected"]:
        return None
    secs = t["trace"].seconds_by_class()["attention"]
    if secs <= 0:
        return None
    return 100.0 * t["attn_bound_s"] / secs
