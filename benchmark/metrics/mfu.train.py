"""mfu.train: the least time of a traced boosting iteration (its
histograms, gradient pass, score update and routing) over the window's
measured ms per tree, in percent."""
from gbdtbench import layer


def read(run):
    w = run.window
    if run.view is None or not w.get("trees"):
        return None
    trees = layer.traced_trees(run)
    per_tree = layer.iteration_least_s(run, trees) / len(trees)
    return 100.0 * per_tree / (w["seconds"] / w["trees"])
