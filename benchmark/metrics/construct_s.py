"""construct_s: the harness's clock around Dataset.construct() in
set-up (the Loading layer)."""


def read(run):
    return run.layer.get("construct_s")
