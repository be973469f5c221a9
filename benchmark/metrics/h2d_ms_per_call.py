"""h2d_ms_per_call: host-to-device and device-to-host copy time a call,
launched inside the harness's bench.predict ranges (profiler)."""
from gbdtbench import layer


def read(run):
    if run.view is None:
        return None
    events = layer.in_ranges(run, "bench.predict")
    if events is None:
        return None
    ms = sum(e["dur"] for e in events if e["cat"] == "gpu_memcpy") * 1e3
    return ms / run.layer["trace_calls"] if ms > 0 else None
