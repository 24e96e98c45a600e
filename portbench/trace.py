"""Reduction of one torch.profiler trace (Chrome trace JSON) to what the
per-layer readers and the result's `breakdown` need.

The traced window runs from the start of the first harness span
`portbench.call` (one around every FAPI call) to the end of the last.
Device activity is every kernel, memcpy and memset on the card; the busy
time is the union of their intervals inside the window.  Host spans are the
`record_function` ranges on the host (the program's and the harness's).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

CALL_SPAN = "portbench.call"
#: Device operation names in the breakdown are cut to this many characters
#: (templated kernel names run to thousands).
NAME_CHARS = 120
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """Intervals in microseconds on the trace's clock."""

    kernels: list = field(default_factory=list)     # (name, start, dur)
    device: list = field(default_factory=list)      # (name, start, dur), kernels and copies
    spans: list = field(default_factory=list)       # (name, start, dur), host ranges
    window: tuple = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device intervals, clipped to the window."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(s + d, hi)) for _, s, d in self.device
                     if s + d > lo and s < hi)
        out: list[list[float]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def span_us(self, name: str) -> float:
        return sum(d for n, _, d in self.spans if n == name)

    def kernel_us(self, contains: str = "") -> float:
        return sum(d for n, _, d in self.kernels if contains in n)


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    t = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, item = ev.get("cat", ""), (ev["name"], float(ev["ts"]), float(ev["dur"]))
        if cat in DEVICE_CATS:
            t.device.append(item)
            if cat == "kernel":
                t.kernels.append(item)
        elif cat == "user_annotation":
            t.spans.append(item)
    calls = [s for s in t.spans if s[0] == CALL_SPAN]
    if calls:
        t.window = (min(s for _, s, _ in calls), max(s + d for _, s, d in calls))
    return t


def innermost_span(spans_sorted: list, starts: list, at: float) -> str:
    """The name of the shortest host span open at time `at`."""
    best, best_dur = "host, outside any span", float("inf")
    i = bisect.bisect_right(starts, at)
    for name, s, d in spans_sorted[max(0, i - 400):i]:
        if s <= at < s + d and d < best_dur:
            best, best_dur = name, d
    return best


def breakdown(t: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    window summed by the innermost host span open at each gap's middle."""
    ops: dict[str, float] = defaultdict(float)
    lo, hi = t.window
    for name, s, d in t.device:
        if s + d > lo and s < hi:
            ops[name[:NAME_CHARS]] += d * 1e-6
    spans = sorted(t.spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    gaps: dict[str, float] = defaultdict(float)
    prev = lo
    for s, e in t.busy_intervals() + [(hi, hi)]:
        if s > prev:
            gaps[innermost_span(spans, starts, (prev + s) / 2)] += (s - prev) * 1e-6
        prev = max(prev, e)
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": order(ops), "idle_gaps": order(gaps)}
