"""train_ms_per_tree: the window's wall over the trees grown in it, the
window's edges synchronised (host clock)."""


def read(run):
    w = run.window
    return 1e3 * w["seconds"] / w["trees"] if w.get("trees") else None
