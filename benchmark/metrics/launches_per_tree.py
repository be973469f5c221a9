"""launches_per_tree: device kernels, memory copies and memory sets of
the traced iterations, a tree (profiler)."""


def read(run):
    if run.view is None or not run.layer.get("trace_iterations"):
        return None
    lo, hi = run.traced_span
    return len(run.view.device_in(lo, hi)) / run.layer["trace_iterations"]
