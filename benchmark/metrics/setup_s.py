"""setup_s: process start to the window's start (host clock)."""


def read(run):
    return run.setup_s
