"""hist_roofline: the least time of the traced trees' histograms over
the device time of the work launched inside the grower's tel.histogram
ranges (profiler), in percent."""
from gbdtbench import layer


def read(run):
    if run.view is None:
        return None
    events = layer.in_ranges(run, "tel.histogram")
    if not events:
        return None
    busy = run.view.busy(*run.traced_span, events=events)
    if busy <= 0:
        return None
    return 100.0 * layer.hist_least_s(run, layer.traced_trees(run)) / busy
