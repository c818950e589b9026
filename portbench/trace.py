"""The traced run's reading of the profiler: device busy time, kernel
time by name, the runtime's launch calls, and where the device sat
idle.

The profiler records the card's activity alone (kernels, copies, sets,
and the runtime API calls the host made), not every host operator:
recording those costs more than the launch each wraps on launch-bound
paths. The raw trace events are read directly, as `chip_smoke.py`'s
`device_profile` does, since building `key_averages()` over a long run
takes longer than the run.
"""
from __future__ import annotations

import bisect
import time
from typing import NamedTuple

#: Host runtime calls that launch work on the device.
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel",
                   "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
NAME_CHARS = 96
TOP = 10


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Trace:
    """Device and host spans of one traced window of `window_s` host
    seconds."""

    def __init__(self, device: list, host: list, window_s: float):
        self.device = sorted(device, key=lambda s: s.start_ns)
        self.host = sorted(host, key=lambda s: s.start_ns)
        self.window_s = window_s
        self.busy = _merge(self.device)
        self._host_starts = [s.start_ns for s in self.host]
        self._device_starts = [s.start_ns for s in self.device]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self, *needles: str) -> tuple[float, int]:
        """Device seconds and count of the operations whose names hold
        one of `needles`."""
        hit = [s for s in self.device if any(n in s.name for n in needles)]
        return sum(s.end_ns - s.start_ns for s in hit) / 1e9, len(hit)

    @property
    def launch_calls(self) -> int:
        return sum(1 for s in self.host if s.name.startswith(LAUNCH_PREFIXES))

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing: inside a runtime call, or in
        its own code before launching the operation that ended the gap."""
        ops = {}
        for s in self.device:
            key = s.name[:NAME_CHARS]
            ops[key] = ops.get(key, 0) + (s.end_ns - s.start_ns) / 1e9
        spans = self.host + self.device
        gaps = {}
        if spans:
            prev = min(s.start_ns for s in spans)
            for lo, hi in self.busy + [(max(s.end_ns for s in spans),) * 2]:
                if lo > prev:
                    label = self._label(prev, lo)
                    gaps[label] = gaps.get(label, 0) + (lo - prev) / 1e9
                prev = max(prev, hi)
        return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}

    def _label(self, lo: int, hi: int) -> str:
        mid = (lo + hi) // 2
        i = bisect.bisect_right(self._host_starts, mid) - 1
        if i >= 0 and self.host[i].end_ns >= mid:
            return f"in {self.host[i].name}"
        j = bisect.bisect_left(self._device_starts, hi)
        if j == len(self.device):
            return "host after the last device operation"
        return f"host before {self.device[j].name[:NAME_CHARS - 12]}"


def _merge(spans) -> list:
    out = []
    for s in spans:
        if out and s.start_ns <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end_ns)
        else:
            out.append([s.start_ns, s.end_ns])
    return [tuple(p) for p in out]


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def traced(fn):
    """Run fn() under the profiler (device activity only) and return
    (fn's result, Trace). The window is fn's host wall, from its call to
    its return; fn ends in a copy to the host, so the device is done."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        span = Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (device if e.device_type() == DeviceType.CUDA else host).append(span)
    return out, Trace(device, host, window_s)
