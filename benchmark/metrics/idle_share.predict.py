"""idle_share.predict: the share of the traced calls' window with no
kernel, memory copy or memory set on the device (profiler), in
percent."""
from gbdtbench import layer


def read(run):
    return layer.idle_share(run)
