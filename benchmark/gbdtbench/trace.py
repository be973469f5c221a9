"""The traced window: a ``torch.profiler`` capture and what is read from
its Chrome trace.

Device activity is every event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``.  Host ranges are the ``cpu_op``,
``user_annotation`` and ``cuda_runtime`` / ``cuda_driver`` events; a
device event is tied to the host call that launched it by its
``correlation`` argument, and so to every ``record_function`` range that
was open at that call.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


class Capture:
    """``with Capture() as cap: ...`` profiles the block (CPU and
    CUDA activity); ``cap.view()`` parses the trace afterwards.  The
    trace file goes to the temporary directory and is removed once
    read."""

    def __init__(self):
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def view(self) -> "TraceView":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return TraceView(events)


class TraceView:
    """Complete events (``ph == "X"``) of one trace, times in seconds."""

    def __init__(self, events: List[dict]):
        self.device: List[dict] = []
        self.host: List[dict] = []
        self.launch: Dict[int, dict] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ev = {"name": e.get("name", ""), "cat": cat,
                  "t0": float(e.get("ts", 0.0)) * 1e-6,
                  "dur": float(e.get("dur", 0.0)) * 1e-6,
                  "tid": e.get("tid"), "pid": e.get("pid"),
                  "corr": (e.get("args") or {}).get("correlation")}
            ev["t1"] = ev["t0"] + ev["dur"]
            if cat in DEVICE_CATS:
                self.device.append(ev)
            elif cat in LAUNCH_CATS:
                if ev["corr"] is not None:
                    self.launch[ev["corr"]] = ev
                self.host.append(ev)
            elif cat in HOST_CATS:
                self.host.append(ev)
        self.device.sort(key=lambda e: e["t0"])
        self.host.sort(key=lambda e: e["t0"])
        self._host_starts = None
        self._host_ranges: List[dict] = []

    # -- ranges ---------------------------------------------------------
    def ranges(self, name: str, prefix: bool = False) -> List[Tuple[float,
                                                                    float]]:
        """(start, end) of the host ranges named ``name`` (or starting
        with it), in time order."""
        return [(e["t0"], e["t1"]) for e in self.host
                if e["cat"] == "user_annotation"
                and (e["name"].startswith(name) if prefix
                     else e["name"] == name)]

    def launched_in(self, spans: List[Tuple[float, float]]) -> List[dict]:
        """Device events whose launching host call lies inside one of
        ``spans``; None when a device event in the spans' extent has no
        launching call to place it by."""
        if not spans:
            return []
        starts = [s for s, _ in spans]
        lo, hi = spans[0][0], spans[-1][1]
        out = []
        for e in self.device:
            call = self.launch.get(e["corr"])
            if call is None:
                if lo <= e["t0"] <= hi + 1.0:
                    return None
                continue
            t = call["t0"]
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= spans[k][1]:
                out.append(e)
        return out

    # -- device activity ------------------------------------------------
    def busy(self, lo: float, hi: float,
             events: Optional[List[dict]] = None) -> float:
        """Seconds of [lo, hi] in which some device event ran (the union
        of their intervals)."""
        total, end = 0.0, lo
        for e in (self.device if events is None else events):
            a, b = max(e["t0"], end), min(e["t1"], hi)
            if b > a:
                total += b - a
                end = b
            end = max(end, min(e["t1"], hi))
        return total

    def device_in(self, lo: float, hi: float) -> List[dict]:
        return [e for e in self.device if e["t0"] < hi and e["t1"] > lo]

    def gaps(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """Idle intervals of [lo, hi]: no device event running."""
        out, end = [], lo
        for e in self.device:
            if e["t1"] <= lo or e["t0"] >= hi:
                continue
            if e["t0"] > end:
                out.append((end, e["t0"]))
            end = max(end, e["t1"])
        if hi > end:
            out.append((end, hi))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host range open at time t (the latest-started
        of those that cover it), or "host idle"."""
        if self._host_starts is None:
            self._host_ranges = [e for e in self.host
                                 if e["cat"] in HOST_CATS]
            self._host_starts = [e["t0"] for e in self._host_ranges]
        k = bisect.bisect_right(self._host_starts, t)
        for e in reversed(self._host_ranges[max(0, k - 4000):k]):
            if e["t1"] >= t:
                return e["name"]
        return "host idle"


def breakdown(view: TraceView, lo: float, hi: float,
              top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in [lo, hi], and the
    idle time there by the host range open while the device waited."""
    by_op: Dict[str, float] = {}
    for e in view.device_in(lo, hi):
        by_op[e["name"]] = by_op.get(e["name"], 0.0) + e["dur"]
    by_host: Dict[str, float] = {}
    for a, b in view.gaps(lo, hi):
        name = view.host_at((a + b) / 2)
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
