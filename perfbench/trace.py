"""One traced slice of a run: torch.profiler over a callable, reduced to
the device's operations (kernels, copies, sets) with their intervals and
the host's operations that were open meanwhile.

``Trace`` gives the busy seconds (the union of device intervals), the
traced window, device seconds by kernel class, the largest device
operations and the idle gaps named by what the host was doing: the
innermost host operation open at the gap's middle, else the benchmark's
own span (``torch.profiler.record_function`` names starting "bench.").
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Tuple

import torch

# kernel classes by name (the port's kernels, then cuBLAS)
ATTENTION = ("frame_attn_", "band_attn_", "doc_tiles_kernel", "ring_attn_")
GEMM = ("gemm", "gemv", "nvjet", "cutlass", "sm90_xmma")


def kernel_class(name: str) -> str:
    low = name.lower()
    if any(s in low for s in ATTENTION):
        return "attention"
    if any(s in low for s in GEMM):
        return "matmul"
    return "other"


class Trace:
    def __init__(self, device_ops, host_ops, window_s: float):
        self.device_ops = device_ops     # [(name, start_us, end_us)]
        self.host_ops = host_ops         # [(name, start_us, end_us)]
        self.window_s = window_s

    @property
    def kernels(self) -> int:
        return len(self.device_ops)

    def busy_s(self) -> float:
        total, end = 0.0, None
        for _, a, b in sorted((o for o in self.device_ops),
                              key=lambda o: o[1]):
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e6

    def seconds_by_class(self) -> Dict[str, float]:
        out = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
        for name, a, b in self.device_ops:
            out[kernel_class(name)] += (b - a) / 1e6
        return out

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by = {}
        for name, a, b in self.device_ops:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle seconds between device operations (and before the first
        and after the last, within the window), summed by what the host
        was doing, the largest ``n``."""
        if not self.device_ops:
            return []
        ops = sorted(self.device_ops, key=lambda o: o[1])
        t0 = min([h[1] for h in self.host_ops] + [ops[0][1]])
        t1 = t0 + self.window_s * 1e6
        gaps, end = [], t0
        for _, a, b in ops:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if t1 > end:
            gaps.append((end, t1))
        hosts = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        spans = [h for h in hosts if h[0].startswith("bench.")]
        by = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            best = None
            for h in hosts[max(0, i - 400):i] + spans:
                if h[1] <= mid <= h[2] and (best is None or h[2] - h[1]
                                            < best[2] - best[1]):
                    best = h
            name = best[0] if best else "host (no operation open)"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def capture(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` once under the profiler, ending in a device sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and \
                e.device_type == DeviceType.CUDA:
            continue   # device ranges of annotations: not operations
        a = e.time_range.start
        b = e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, a, b))
        else:
            host.append((e.name, a, b))
    return Trace(dev, host, window)
