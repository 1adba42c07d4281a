"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a fixed
part of the window (the mix's ``trace_window``), device activity only, kept
in memory and reduced in the process.  Nothing is written to disk.

Reduced to: the seconds in which some operation ran on the device (the
union of kernel, copy and set intervals), the traced window's length, the
time and launches of each kernel name, and the idle gaps between device
operations, each labelled by what the host was doing then (the scheduler
tick that held it and the engine's work in that tick, or the harness
waiting between ticks).
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, at most ``width`` long."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:width]


class DeviceTrace:
    def __init__(self, clock):
        self.clock = clock
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        # kineto stamps in ns since the epoch; the harness clock is
        # perf_counter since its origin
        self.epoch_minus_clock = time.time() - self.clock()
        self.t0 = self.clock()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = self.clock()
        self.prof.stop()

    def device_events(self) -> list[tuple[str, float, float]]:
        """(name, start, end) of every device operation, on the harness
        clock, clipped to the traced window."""
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(ev.device_type()):
                continue
            a = ev.start_ns() / 1e9 - self.epoch_minus_clock
            b = a + ev.duration_ns() / 1e9
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                out.append((ev.name(), a, b))
        out.sort(key=lambda e: e[1])
        return out

    def reduce(self, ticks: list[tuple[float, float, str]]) -> dict:
        """``ticks``: (start, end, label) of each scheduler tick the harness
        ran in the traced window."""
        evs = self.device_events()
        per = defaultdict(lambda: [0, 0.0])
        busy, gaps = 0.0, []
        cur_a = cur_b = None
        for name, a, b in evs:
            k = per[short_name(name)]
            k[0] += 1
            k[1] += b - a
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                gaps.append((self.t0 if cur_b is None else cur_b, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            busy += cur_b - cur_a
            gaps.append((cur_b, self.t1))
        else:
            gaps.append((self.t0, self.t1))
        labelled = defaultdict(float)
        starts = [t[0] for t in ticks]
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and ticks[i][1] >= mid:
                label = ticks[i][2]
            else:
                label = "harness: between ticks"
            labelled[label] += b - a
        window = self.t1 - self.t0
        return {
            "window_s": window,
            "busy_s": busy,
            "kernels": {n: (c, s) for n, (c, s) in per.items()},
            "device_ops": sorted(([n, s] for n, (c, s) in per.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in labelled.items()),
                                key=lambda x: -x[1])[:10],
        }
