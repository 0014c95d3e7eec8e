"""Reduction of a torch.profiler window to the numbers the per-layer
metrics read: device busy time (the union of every kernel, copy and set
on the device), device time by operation name, and the idle gaps between
device operations with what the host was doing in each.

The profiler records the host's operations, the benchmark's own spans
(``span``, a record_function range around each call into the program)
and, through CUPTI, the device's. A gap is named after the innermost host
event that spans its middle; with none, "host: no event".
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def span(name: str):
    """A named range on the profiler's host timeline (a no-op cost when no
    profiler runs)."""
    return torch.profiler.record_function(f"meshbench.{name}")


class Window:
    """What one profiled sub-window showed."""

    def __init__(self, device_events, host_events, wall_s: float):
        self.wall_s = wall_s
        dev = sorted(device_events)
        self.by_name: dict[str, float] = {}
        for start, end, name in dev:
            self.by_name[name] = self.by_name.get(name, 0.0) + (end - start)
        merged = []
        for start, end, _ in dev:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        self.busy_s = sum(e - s for s, e in merged)
        self.gaps = [(merged[i][1], merged[i + 1][0])
                     for i in range(len(merged) - 1)
                     if merged[i + 1][0] > merged[i][1]]
        self._host = sorted(host_events)

    def device_seconds(self, match) -> float:
        """Device seconds of the operations whose name `match` accepts."""
        return sum(t for name, t in self.by_name.items() if match(name))

    def top_ops(self, n: int = 10) -> list:
        return [[name, t] for name, t in sorted(
            self.by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list:
        """Idle seconds between device operations, summed by the host event
        that spans each gap's middle, largest first."""
        if not self.gaps:
            return []
        starts = np.array([h[0] for h in self._host])
        totals: dict[str, float] = {}
        for a, b in self.gaps:
            mid = 0.5 * (a + b)
            label = "host: no event"
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            best = None
            # the innermost event holding mid: the latest start before it
            for j in range(i, max(i - 4000, -1), -1):
                s, e, name = self._host[j]
                if e >= mid:
                    best = name
                    break
            if best is not None:
                label = best
            totals[label] = totals.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def profiled(result: dict):
    """Profile the body (host and CUDA activity); on exit, after a device
    synchronize, result["window"] holds the body's Window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            # a record_function range also shows on the device's timeline
            if not getattr(e, "is_user_annotation", False):
                device.append((start, end, e.name))
        elif not getattr(e, "is_async", False):
            host.append((start, end, e.name))
    result["window"] = Window(device, host, wall)
