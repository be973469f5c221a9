"""predict_p95_ms: the 95th percentile of the latency of every call in
the window (host clock); the count is printed to standard error."""
import sys

import numpy as np


def read(run):
    lat = run.window.get("latencies")
    if not lat:
        return None
    print(f"predict_p95_ms over {len(lat)} calls", file=sys.stderr)
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
