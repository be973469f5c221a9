"""Per-host step-wall monitoring + straggler detection.

Port of lightgbm_tpu/parallel/monitor.py (gauge and counter names
unchanged).

The analog of the reference's ``GlobalSyncUpByMin/Max/Mean`` scalar
syncs (network.h:165-257): after each training dispatch every host
contributes its step wall to a tiny allgather, and every host derives
the same max/min/mean — the ``straggler_ratio`` gauge
(``max / mean``) is the one number that says whether the fleet is
compute-bound or waiting on one slow host.  Straggler/imbalance is THE
dominant distributed-GBDT failure mode (PAPERS.md: arXiv 1706.08359
§data-parallel scaling, LiteMORT 2001.09419), and before this module
it was only visible by diffing N per-host logs by hand.

Wired into ``GBDT.train_one_iter`` when telemetry is on and the run
spans multiple processes; the gather is a collective,
so the call sites are the SPMD training loop every host executes in
lockstep.  ``gather`` is injectable so the single-process test suite
can exercise the exact ratio math with simulated hosts (thread-barrier
fakes), the way ``LGBM_NetworkInitWithFunctions`` let the reference
fake its network.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ..telemetry import TELEMETRY
from ..utils.log import Log

# ratio above which a step is counted as straggled (warned once per
# process, counted always): max/mean = 1.5 means the slowest host
# left the others idle for half a mean step
STRAGGLER_WARN_RATIO = 1.5

_warned = {"straggler": False}


def step_wall_stats(times_s) -> Dict[str, float]:
    """max/min/mean/ratio over per-host step walls (seconds) — the
    pure reduction both the production gather and the tests share."""
    times = [float(t) for t in times_s]
    if not times:
        raise ValueError("step_wall_stats needs at least one sample")
    mx = max(times)
    mn = min(times)
    mean = sum(times) / len(times)
    return {
        "max": mx,
        "min": mn,
        "mean": mean,
        "ratio": (mx / mean) if mean > 0 else 1.0,
    }


def _default_gather(seconds: float) -> Optional[List[float]]:
    """Allgather this host's step wall across processes (None when the
    run is single-process — there is nothing to compare).  An
    installed TCP transport (``collective_transport=tcp``) carries the
    exchange directly — the straggler monitor then works on the
    host-side data plane with no other distributed runtime, and the
    round is traced/accounted as a ``transport_round`` like every
    other transport collective.  Otherwise (the device plane,
    ``collective_transport=xla``) the exchange routes through
    ``distributed._allgather``, over the plane's gloo host group (never
    through a card), so it passes the ``collectives.allgather`` fault
    seam and shows up in the ``collective_host_allgather_*`` accounting
    like every other host collective."""
    import numpy as np

    from . import transport as _transport
    t = _transport.active()
    if t is not None and t.world_size > 1:
        gathered = t.allgather(np.asarray([seconds], dtype=np.float64))
        return [float(x) for x in np.asarray(gathered).ravel()]
    if TELEMETRY._n_hosts() <= 1:
        return None
    from .distributed import _allgather
    gathered = _allgather(np.asarray([seconds], dtype=np.float64))
    return [float(x) for x in np.asarray(gathered).ravel()]


def record_step_wall(seconds: float,
                     gather: Optional[Callable] = None
                     ) -> Optional[Dict[str, float]]:
    """Record this host's step wall and — when the run spans hosts —
    the fleet-wide max/min/mean and ``straggler_ratio`` gauges
    (docs/OBSERVABILITY.md, distributed observability).

    ``gather(seconds) -> [per-host seconds]`` is the collective; the
    default allgathers over the active transport's processes and
    returns None single-process.  With no injected gather, the cross-host exchange
    only runs when the device fence is active (``telemetry=spans``, or
    ``counters`` with the bench's explicit fence): unfenced "step
    wall" is just the async enqueue time — straggler_ratio over it
    would measure host Python jitter, not device-step skew — and
    counters mode is documented to add NO blocking work to the
    dispatch pipeline.  Returns the stats dict when a gather
    happened."""
    tm = TELEMETRY
    if not tm.on:
        return None
    tm.gauge("step_wall_ms", round(seconds * 1e3, 3))
    # histogram under its own family name: `step_wall_ms` is already a
    # gauge, and one Prometheus metric name cannot be both
    tm.observe("step_wall_hist_ms", seconds * 1e3)
    if gather is None and not (tm.spans_on or tm.fence_active):
        return None
    times = (gather or _default_gather)(seconds)
    if not times or len(times) < 2:
        return None
    st = step_wall_stats(times)
    tm.gauge("step_wall_ms_max", round(st["max"] * 1e3, 3))
    tm.gauge("step_wall_ms_min", round(st["min"] * 1e3, 3))
    tm.gauge("step_wall_ms_mean", round(st["mean"] * 1e3, 3))
    ratio = round(st["ratio"], 4)
    tm.gauge("straggler_ratio", ratio)
    tm.gauge_max("straggler_ratio_peak", ratio)
    if ratio >= STRAGGLER_WARN_RATIO:
        tm.add("straggler_steps", 1)
        if not _warned["straggler"]:
            _warned["straggler"] = True
            slow = max(range(len(times)), key=lambda i: times[i])
            Log.warning(
                f"straggler detected: slowest host {slow} at "
                f"{st['max'] * 1e3:.1f} ms vs fleet mean "
                f"{st['mean'] * 1e3:.1f} ms (ratio {ratio}; warned "
                "once — straggler_ratio / straggler_steps keep "
                "counting, docs/OBSERVABILITY.md)")
    return st
