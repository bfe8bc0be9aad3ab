"""The readings that set a cell's limits: the program's own (``sound``:
its set-up's checked steps, as a run takes them, with no window), the
control (the plain reference computed in float8 in the program's place)
and the planted faults, each against the float32 reference, at the
cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--what sound,control,half] [--ticks N]

For a training cell the reference's draws come from the program's
generator states where ``sound`` runs the program first, else from one
generator seeded as the program's; ``half`` leaves out half of each
batch, the loss the mean over the rest; ``unchanged`` takes steps that
leave the parameters and their EMA as they were. For the serve cell
``--ticks`` sets how many ticks the session runs (a run compares its
first ``ref_ticks``, 850); ``control`` runs the loop in float8. Prints one JSON line per seed and
reading. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(name, seed, what, ticks=None, device="cuda", overrides=None):
    """{reading: numbers} for one seed."""
    from perfbench import run as R
    import torch
    R.cache_env(ROOT)
    cell = R.Cell(ROOT, name)
    dev = torch.device(device)
    drv = cell.driver_cls(R.Run(cell, seed, dev, overrides))
    out = {}
    if drv.kind == "serve":
        drv.ctx = drv.inputs()
        drv.outputs = [None] * (ticks or drv.tr["warm_ticks"])
        ref = drv.reference("fp32")
        if "control" in what:
            drv.outputs = [(v.cpu(), a.cpu()) for v, a in
                           drv.reference("fp8")]
            out["control"] = drv.compare(ref)[0]
        return out
    chained = "sound" not in what
    if not chained:
        drv.setup()
        drv.free()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    states = drv.checked["states"] if not chained else None
    ref = drv.reference("fp32", chained=chained)
    if not chained:
        out["sound"] = drv.compare(ref)[0]

    def planted(**kw):
        got = drv.reference(chained=chained, **kw)
        drv.checked = dict(got, states=states)
        return drv.compare(ref)[0]

    if "control" in what:
        out["control"] = planted(precision="fp8")
    if "half" in what and drv.tc["batch_size"] > 1:
        out["half"] = planted(rows=slice(0, drv.tc["batch_size"] // 2))
    if "unchanged" in what:
        out["unchanged"] = planted(update=False)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="control,half,unchanged")
    ap.add_argument("--ticks", type=int, default=None)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(args.workload, seed, args.what.split(","),
                       args.ticks)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "readings": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
