"""predict_rows_per_s: the rows scored in the window over the window
(host clock)."""


def read(run):
    w = run.window
    return w["rows"] / w["seconds"] if w.get("calls") else None
