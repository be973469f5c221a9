"""idle_share.train: the share of the traced iterations' window with no
kernel, memory copy or memory set on the device (profiler), in
percent."""
from gbdtbench import layer


def read(run):
    return layer.idle_share(run)
