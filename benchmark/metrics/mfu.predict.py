"""mfu.predict: the least time of one scoring call (its rows, model and
scores over the bandwidth, or its node visits over 67 T/s, whichever is
longer) over the window's measured time a call, in percent."""
from gbdtbench import roofline


def read(run):
    w = run.window
    if run.view is None or not w.get("calls") or "visits" not in run.layer:
        return None
    least = roofline.predict_least_seconds(
        run.layer["rows"], run.layer["num_features"], 8,
        run.layer["trees"], run.layer["visits"])
    return 100.0 * least / (w["seconds"] / w["calls"])
