"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic and its metrics are found by
name: BENCHMARK.json names them, ``perfbench/configs/<config>.json``
holds the configuration as run, ``perfbench/traffic/<traffic>.json`` the
traffic mix's parameters, ``perfbench/workloads/<cell>.json`` the driver
(``perfbench/drivers/<driver>.py``), the checked steps and the limits of
the correctness check, and ``perfbench/metrics/<metric>.py`` reads one
per-layer metric (``read(ctx)``, None where it finds nothing).

A run: set-up (everything up to the first timed step, warm-up included),
the window of ``--seconds``, with ``--trace 1`` a traced slice after it,
then, with the program's state freed, the plain reference (reference/)
on the same inputs and the comparison that decides ``correct``. A run
exits non-zero and prints no result without a CUDA device, with fewer
devices than the cell asks for, or when the JAX package or JAX itself
was loaded (``run_cell(..., device="cpu")`` runs the rest of a run on
the CPU, for the tests).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "owl_audio_exps_tpu")


def cache_env(root: Path):
    """Every build and kernel cache at a fixed path inside the checkout;
    JAX kept out of the libraries that would load it."""
    cache = root / "build" / "perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell resolved by name: its BENCHMARK.json entry, configuration,
    workload file, driver class and the readers of its per-layer
    metrics."""

    def __init__(self, root: Path, name: str):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = json.loads((root / self.config_entry["file"])
                                 .read_text())
        self.workload = json.loads(
            (root / "perfbench" / "workloads" / f"{name}.json").read_text())
        self.workload["traffic"] = json.loads(
            (root / "perfbench" / "traffic" / f"{self.entry['traffic']}.json")
            .read_text())
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        drv = self.workload["driver"]
        self.driver_cls = load_module(
            root / "perfbench" / "drivers" / f"{drv}.py",
            f"perfbench_driver_{drv}").Driver
        self.readers = {m["name"]: load_module(
            root / "perfbench" / "metrics" / f"{m['name']}.py",
            f"perfbench_metric_{m['name'].replace('.', '_')}").read
            for m in self.per_layer}


class Run:
    def __init__(self, cell, seed, device, overrides=None):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.config = copy.deepcopy(cell.config)
        self.workload = copy.deepcopy(cell.workload)
        for key, value in (overrides or {}).items():
            node, *path = key.split(".")
            tgt = self.config if node == "config" else self.workload
            for k in path[:-1]:
                tgt = tgt[k]
            tgt[path[-1]] = value


def device_info(torch, device, peak_bytes, n):
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": n,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": n, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def log(*a):
    print("[perfbench]", *a, file=sys.stderr, flush=True)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: int,
             device: str = "cuda", overrides=None):
    """One run of the cell; returns the result dict (None where the run
    must print none)."""
    cache_env(root)
    import torch

    cell = Cell(root, name)
    if device == "cuda":
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell.chips:
            log(f"needs {cell.chips} CUDA device(s); found {found}")
            return None
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    run = Run(cell, seed, dev, overrides)
    drv = cell.driver_cls(run)
    log(f"{name}: seed {seed}, {seconds} s, trace {trace}; "
        f"{power_limit() if dev.type == 'cuda' else 'cpu'}")
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START
    window = drv.window(seconds)
    traced = drv.traced() if trace else None
    # the process's peak: the window resets the counter at its start
    # and records the set-up's peak first
    peak = 0 if dev.type != "cuda" else max(
        torch.cuda.max_memory_allocated(dev), window["setup_peak_bytes"])
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return None
    attempted, failed_run = drv.answers(window)
    metrics = {}
    if trace:
        ctx = LayerContext(drv, window, traced)
        for m in cell.per_layer:
            v = cell.readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for k, (v, unit) in drv.end_to_end(window).items():
            metrics[k] = {"value": v, "unit": unit}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    drv.free()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers, notes = drv.compare(drv.reference())
    log(f"reference and comparison took {time.perf_counter() - t0:.1f} s; "
        f"{notes}")
    limits = run.workload["limits"]
    # a number that is not finite is out of every limit; JSON has no inf
    numbers = {k: v if math.isfinite(v) else 1e30 for k, v in numbers.items()}
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed_run == 0 and all(v <= limits[k]
                                      for k, v in numbers.items())
    if forbidden_modules():
        log(f"modules of JAX or the JAX package were loaded: "
            f"{forbidden_modules()}")
        return None
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed_run),
              "metrics": metrics,
              "device": device_info(torch, dev, peak, cell.chips)}
    if traced is not None:
        tr = traced["trace"]
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr.top_ops(10)],
            "idle_gaps": [[n, s] for n, s in tr.idle_gaps(10)]}
    result["checks"] = checks
    return result


class LayerContext:
    """What a per-layer metric reads: the driver, the window's record and
    the traced slice's."""

    def __init__(self, driver, window, traced):
        self.driver, self.window, self.traced = driver, window, traced
        self.config = driver.mc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      args.trace)
    if result is None:
        return 1
    log(f"correct {result['correct']}")
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
