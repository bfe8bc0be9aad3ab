"""The training step's phases as the program records them: the spans of
``owl_audio_exps_tpu_torch.utils.profiling`` (``spans()``: name, parent,
step, host start and end, device ms between the span's two CUDA events)
made during the traced slice, and their ``record_function`` ranges among
the trace's host operations, on the kernels' clock.

A phase's device ms are its busy time: the ms between its events, which
also hold the idle the host leaves the card while it launches the
phase's work, less that idle (the gaps whose middle falls inside the
phase's host range). A program without spans (an older commit) gives no
records, and every reader here then returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from perfbench.trace import Trace

FORWARD, BACKWARD, UPDATE = ("owl.train.forward", "owl.train.backward",
                             "owl.train.update")
PHASES = (FORWARD, BACKWARD, UPDATE)
STEP = "owl.train.step"
WAIT = "owl.data.wait"


def program_spans() -> List[Dict]:
    """The program's span records, [] where it keeps none or dropped
    some past its cap."""
    try:
        from owl_audio_exps_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    if read is None or getattr(profiling, "dropped", 0):
        return []
    return list(read())


def traced_spans(ctx) -> Optional[List[Dict]]:
    """The records of the traced slice; None without a traced slice,
    without records, or where the records hold another number of steps
    than the slice ran (records of more than one capture)."""
    t = ctx.traced
    if t is None:
        return None
    recs = program_spans()
    if sum(r["name"] == STEP for r in recs) != t["steps"]:
        return None
    return recs


def device_ms_per_step(ctx, name: str):
    """Busy device ms a traced step of the phase ``name``: the ms between
    each of its spans' two events, summed over the traced steps, per
    step, less the phase's idle; None without such records."""
    recs = traced_spans(ctx)
    ms = [r["device_ms"] for r in recs or ()
          if r["name"] == name and r["device_ms"] is not None]
    idle = idle_ms_per_step(ctx, name)
    if not ms or idle is None:
        return None
    return sum(ms) / ctx.traced["steps"] - idle


def idle_by_span(trace: Trace, names: Sequence[str]) -> Dict[str, float]:
    """Idle seconds of the traced window by the innermost host range
    among ``names`` open at each gap's middle (the card idles only once
    it has run every launch, so the host then stands where the device
    does), as ``Trace.idle_gaps`` names gaps; the rest under its
    "host (no operation open)"."""
    hosts = [h for h in trace.host_ops if h[0] in names]
    if trace.host_ops:
        # an empty range at the first host operation keeps the window's
        # start where the whole trace has it
        t0 = min(h[1] for h in trace.host_ops)
        hosts.append(("", t0, t0))
    return dict(Trace(trace.device_ops, hosts, trace.window_s)
                .idle_gaps(len(names) + 2))


def idle_ms_per_step(ctx, name: str):
    """Idle device ms a traced step in gaps whose middle falls inside the
    phase ``name`` (the innermost open of forward, backward and update);
    None where the trace has no device operation or no range of a
    phase."""
    t = ctx.traced
    if t is None:
        return None
    tr = t["trace"]
    if not tr.device_ops or not any(h[0] in PHASES for h in tr.host_ops):
        return None
    return 1e3 * idle_by_span(tr, PHASES).get(name, 0.0) / t["steps"]


def wait_share(ctx):
    """The ``owl.data.wait`` spans' host seconds over the traced window;
    in %. None without such records."""
    recs = [r for r in traced_spans(ctx) or () if r["name"] == WAIT]
    if not recs:
        return None
    secs = sum(r["host_end_ns"] - r["host_start_ns"] for r in recs) / 1e9
    return 100.0 * secs / ctx.traced["trace"].window_s
