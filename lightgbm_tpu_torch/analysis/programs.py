"""The registered entry points, recorded at small probe shapes (the
counterpart of lightgbm_tpu/analysis/programs.py, whose probe shapes it
keeps).

Torch eager has no program to lower, so a :class:`Program` here is what
one call of an entry point dispatched: its torch ops (``walker``) and
its kernel launches.  The entry points:

- ``GBDT.train_one_iter`` on the main path (binary, ``quantized_grad``,
  ``hist_compute_dtype=bfloat16``: the ``fused_tiled`` plan, kernels A
  and B), its first two iterations, on the 512x6 carry probe of the JAX
  package,
- ``predict_level_ensemble`` (kernel C) over the first 4 and the first
  12 trees of the 220x9 predict probe, 16 rows, on the records that the
  serving predictor packs once per model,
- ``exchange_histograms`` under q16, two shards' (6, 4, 16, 3) f32
  histograms on the probe device.

A :class:`ProgramSet` records each at most once, on one device:
``"cuda"`` by default (the port's device rule: it raises without a
card), ``"cpu"`` for the tests.  On the CPU the wrappers take their
plain versions; the program rules leave those ops out
(``ast_rules.cpu_only_ranges``), so that both devices are held to the
same card path.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .core import PKG_NAME
from .walker import OpRecord, Recorder


class Program:
    """One recorded entry-point call: its ops, its kernel launches and
    rule metadata."""

    def __init__(self, name: str, source: str, ops: List[OpRecord],
                 launches: Optional[Dict[str, int]], device: str,
                 meta: Optional[Dict] = None):
        self.name = name
        self.source = source            # repo-relative defining file
        self.ops = list(ops)
        self.launches = dict(launches or {})
        self.device = device
        self.meta = dict(meta or {})

    def __repr__(self):
        return f"<Program {self.name} ({self.source}, {len(self.ops)} ops)>"


def record(name: str, source: str, setup: Callable, fn: Callable,
           device: str, cpu_ranges=None, **meta) -> Program:
    """Make the inputs, ``args = setup()``, with the recorder paused,
    then record ``fn(*args)``: its Program."""
    with Recorder(device, cpu_ranges) as rec:
        with rec.paused():
            args = setup()
        fn(*args)
    return Program(name, source, rec.ops, rec.launches, device, meta)


# -- probe models (the JAX package's probe shapes) ---------------------------

def build_probe_gbdt(device: str, **params):
    """The main-path probe GBDT: 512x6 binary, 7 leaves, int8 gradients
    on the fused_tiled plan."""
    import numpy as np

    from ..basic import Dataset
    from ..boosting.gbdt import GBDT
    from ..config import Config

    rng = np.random.RandomState(7)
    X = rng.randn(512, 6)
    y = (X[:, 0] + 0.4 * X[:, 1] > 0).astype(float)
    cfg = Config.from_params({"objective": "binary", "num_leaves": 7,
                              "verbose": -1, "min_data_in_leaf": 5,
                              "quantized_grad": True,
                              "hist_compute_dtype": "bfloat16",
                              "device": device, **params})
    core = Dataset(X, label=y).construct(cfg)
    return GBDT(cfg, core)


def train_probe_booster(device: str, f: int = 9, leaves: int = 13,
                        iters: int = 12, n: int = 220, seed: int = 0):
    """The predict probe: 220x9 regression, 13 leaves, 12 trees."""
    import numpy as np

    from ..basic import Dataset
    from ..engine import train

    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = X[:, 0] - 0.4 * X[:, 1]
    p = {"objective": "regression", "verbose": -1, "num_leaves": leaves,
         "min_data_in_leaf": 5, "device": device}
    bst = train(p, Dataset(X, label=y), iters, verbose_eval=False)
    return bst, X


def level_records(bst, t_count: int, device: str):
    """(LevelRecords, depth) of the first ``t_count`` trees, packed as
    the serving predictor packs them once per model."""
    import torch

    from ..ops.predict import level_ensemble_from_numpy, pack_level_records
    from ..tree import flatten_ensemble

    bst._sync_models()
    flat = flatten_ensemble(bst.models[:t_count], 1)
    depth = int(flat.pop("depth"))
    return pack_level_records(level_ensemble_from_numpy(
        flat, torch.device(device))), depth


class ProgramSet:
    """Lazy registry of the recorded entry points on one device."""

    GBDT_SRC = f"{PKG_NAME}/boosting/gbdt.py"
    PREDICT_SRC = f"{PKG_NAME}/ops/predict.py"
    EXCHANGE_SRC = f"{PKG_NAME}/parallel/collectives.py"

    def __init__(self, device: str = "cuda", cpu_ranges=None):
        from ..config import Config
        from ..utils.device import resolve_device
        self.device = str(resolve_device(Config.from_params(
            {"device": device, "verbose": -1})).type)
        # the CPU-only lines, for the placement of a CPU run
        self.cpu_ranges = cpu_ranges
        self._cache: Dict[str, Program] = {}
        self._booster = None

    @property
    def booster(self):
        if self._booster is None:
            self._booster = train_probe_booster(self.device)
        return self._booster

    def _memo(self, name: str, build: Callable[[], Program]) -> Program:
        if name not in self._cache:
            self._cache[name] = build()
        return self._cache[name]

    def train_step(self) -> Program:
        """The first two iterations of GBDT.train_one_iter on the main
        path."""
        def setup():
            g = build_probe_gbdt(self.device)
            if g.grower.plan.name != "fused_tiled":
                raise AssertionError(
                    f"the train probe resolved the {g.grower.plan.name} "
                    "plan, not the main path's fused_tiled")
            return (g,)

        def two(g):
            g.train_one_iter()
            g.train_one_iter()
        return self._memo("train_one_iter", lambda: record(
            "train_one_iter", self.GBDT_SRC, setup, two, self.device,
            self.cpu_ranges, iterations=2))

    def predict_level(self, t_count: int) -> Program:
        from ..ops.predict import predict_level_ensemble
        bst, X = self.booster

        def setup():
            import torch
            rec, depth = level_records(bst, t_count, self.device)
            x2 = torch.zeros((16, 2 * X.shape[1]), dtype=torch.float32,
                             device=torch.device(self.device))
            return rec, x2, depth

        return self._memo(f"predict_level@T{t_count}", lambda: record(
            f"predict_level@T{t_count}", self.PREDICT_SRC, setup,
            lambda rec, x2, depth: predict_level_ensemble(rec, x2,
                                                          depth=depth),
            self.device, self.cpu_ranges, probe_t=t_count))

    def hist_exchange(self, mode: str = "q16") -> Program:
        from ..parallel.collectives import exchange_histograms

        def setup():
            import numpy as np
            import torch
            rng = np.random.RandomState(3)
            return ([torch.from_numpy(rng.randn(6, 4, 16, 3).astype(
                np.float32)).to(torch.device(self.device))
                for _ in range(2)],)

        return self._memo(f"hist_exchange@{mode}", lambda: record(
            f"hist_exchange@{mode}", self.EXCHANGE_SRC, setup,
            lambda hists: exchange_histograms(hists, mode), self.device,
            self.cpu_ranges, world=2))

    def all_programs(self) -> List[Program]:
        return [self.train_step(), self.predict_level(4),
                self.predict_level(12), self.hist_exchange("q16")]
