"""Inputs made from ``--seed``: the rows of each configuration's
generator, and the random model text that the scoring traffic loads.

The concept (the weights below) is part of the configuration and comes
from a generator seeded with ``CONCEPT_SEED``, so that every seed draws
rows of the same task and trees of the same sizes; every other draw
comes from one ``torch.Generator`` on the run's device seeded with the
run's seed (any whole number below 2**63), in a few large calls.  The
rows are handed to the program as NumPy arrays, as users hand them.

- ``binary``: a synthetic two-class task, the concept of the repository's
  ``make_data``: standard normal float32 features, a sparse linear
  concept (each weight normal, kept with probability 0.7) plus
  0.5 sin(3 x0) x1, logistic label noise.
- ``ranking``: a synthetic MS-LTR-shaped task, the concept of
  ``make_ltr_data``: queries of a uniform size in [docs_lo, docs_hi],
  standard normal features, a latent score of a sparse linear concept
  (weights kept with probability 0.5) plus a per-query offset and noise,
  graded 0-4 at its 0.55/0.78/0.90/0.97 quantiles.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


#: the seed of the configurations' concepts (make_data's default seed)
CONCEPT_SEED = 7


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _randn(gen, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def _rand(gen, shape, device, dtype=torch.float32):
    return torch.rand(shape, generator=gen, device=device, dtype=dtype)


def _weights(f: int, keep: float, device) -> torch.Tensor:
    gen = generator(CONCEPT_SEED, "cpu")
    w = torch.randn(f, generator=gen) * (torch.rand(f, generator=gen) > keep)
    return w.to(device)


def binary_rows(gen, n: int, f: int, device):
    """(X float32 (n, f), y float32 (n,)) on the device."""
    w = _weights(f, 0.3, device)
    X = _randn(gen, (n, f), device)
    logit = X @ w + 0.5 * torch.sin(3 * X[:, 0]) * X[:, 1]
    u = _rand(gen, (n,), device).clamp(1e-7, 1 - 1e-7)
    y = (logit + torch.log(u / (1 - u)) > 0).to(torch.float32)
    return X, y


def query_sizes(gen, n_queries: int, lo: int, hi: int, device) -> np.ndarray:
    return torch.randint(lo, hi + 1, (n_queries,), generator=gen,
                         device=device).cpu().numpy().astype(np.int64)


def ranking_rows(gen, sizes: np.ndarray, f: int, device):
    """(X float32 (n, f), graded y float32 (n,)) on the device."""
    n = int(sizes.sum())
    w = _weights(f, 0.5, device)
    X = _randn(gen, (n, f), device)
    offset = torch.repeat_interleave(
        _randn(gen, (len(sizes),), device) * 2.0,
        torch.as_tensor(sizes, device=device))
    latent = X @ w + offset + _randn(gen, (n,), device) * 2.0
    qs = torch.quantile(latent[torch.randperm(n, generator=gen,
                                              device=device)[:1 << 20]],
                        torch.tensor([0.55, 0.78, 0.90, 0.97],
                                     device=device))
    y = torch.bucketize(latent, qs, right=True).to(torch.float32)
    return X, y


def make_rows(cfg: Dict, seed: int, device, rows: int = 0):
    """The configuration's training rows from the seed: a dict with X
    (float32, on the device), y, and for ranking the query sizes.
    ``rows`` (tests only) cuts the row count."""
    data = cfg["data"]
    gen = generator(seed, device)
    f = int(data["num_features"])
    if data["generator"] == "binary":
        n = rows or int(data["num_data"])
        X, y = binary_rows(gen, n, f, device)
        return {"X": X, "y": y, "group": None}
    if data["generator"] == "ranking":
        nq = int(data["num_queries"])
        if rows:
            nq = max(2, rows // ((data["docs_lo"] + data["docs_hi"]) // 2))
        sizes = query_sizes(gen, nq, int(data["docs_lo"]),
                            int(data["docs_hi"]), device)
        X, y = ranking_rows(gen, sizes, f, device)
        return {"X": X, "y": y, "group": sizes}
    raise ValueError(f"unknown generator {data['generator']!r}")


def score_rows(cfg: Dict, seed: int, n: int, batches: int, device):
    """``batches`` float64 batches of ``n`` rows of the configuration's
    feature distribution (standard normal), on the device."""
    gen = generator(seed ^ 0x5C0E, device)
    f = int(cfg["data"]["num_features"])
    return [_randn(gen, (n, f), device, torch.float64)
            for _ in range(batches)]


def bin_edges(X: torch.Tensor, max_bin: int) -> List[np.ndarray]:
    """Each column's max_bin - 1 inner boundaries at its quantiles (over
    a sample of at most 2**20 rows), rounded to float32 and deduplicated
    as a binner's midpoints would be."""
    n = X.shape[0]
    step = max(1, n // (1 << 20))
    q = torch.linspace(0, 1, max_bin + 1, device=X.device,
                       dtype=torch.float64)[1:-1]
    e = torch.quantile(X[::step].to(torch.float64), q, dim=0).T
    return [np.unique(row.astype(np.float32).astype(np.float64))
            for row in e.cpu().numpy()]


def random_model_text(cfg: Dict, model: Dict, edges: List[np.ndarray],
                      seed: int) -> str:
    """A LightGBM model text of ``model["trees"]`` trees of
    ``model["num_leaves"]`` leaves, each grown leaf-wise: a leaf drawn
    uniformly splits on a feature drawn uniformly, at a boundary drawn
    uniformly from those inside the leaf's range of that feature; leaf
    values normal with scale ``model["leaf_scale"]``.  The counts are
    of a uniform spread over the boundaries (a weight of 1 a bin)."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    F = int(cfg["data"]["num_features"])
    L = int(model["num_leaves"])
    scale = float(model["leaf_scale"])
    nb = np.array([len(e) for e in edges])
    blocks = []
    for t in range(int(model["trees"])):
        lo = np.zeros((L, F), dtype=np.int64)       # first bin in range
        hi = np.tile(nb + 1, (L, 1))                 # one past the last
        cnt = np.zeros(L)
        cnt[0] = 1.0
        sf, thr, lc, rc, gain, icnt = [], [], [], [], [], []
        slot_of = {0: None}
        leaves = 1
        while leaves < L:
            leaf = int(rng.integers(leaves))
            room = hi[leaf] - lo[leaf]
            feats = np.flatnonzero(room >= 2)
            f = int(rng.choice(feats))
            b = int(rng.integers(lo[leaf, f], hi[leaf, f] - 1))
            frac = (b + 1 - lo[leaf, f]) / room[f]
            new = leaves
            lo[new], hi[new] = lo[leaf], hi[leaf]
            hi[leaf, f] = b + 1
            lo[new, f] = b + 1
            icnt.append(cnt[leaf])
            cnt[new] = cnt[leaf] * (1 - frac)
            cnt[leaf] = cnt[leaf] * frac
            node = len(sf)
            sf.append(f)
            thr.append(edges[f][b])
            gain.append(float(rng.exponential()))
            lc.append(~leaf)
            rc.append(~new)
            s = slot_of[leaf]
            if s is not None:
                (lc if s[1] == 0 else rc)[s[0]] = node
            slot_of[leaf] = (node, 0)
            slot_of[new] = (node, 1)
            leaves += 1
        values = rng.normal(0.0, scale, L)
        total = 1_000_000
        blocks.append("\n".join([
            f"Tree={t}", f"num_leaves={L}", "num_cat=0",
            "split_feature=" + " ".join(map(str, sf)),
            "split_gain=" + " ".join(f"{x:.6g}" for x in gain),
            "threshold=" + " ".join(f"{x:.17g}" for x in thr),
            "decision_type=" + " ".join("2" for _ in sf),
            "left_child=" + " ".join(map(str, lc)),
            "right_child=" + " ".join(map(str, rc)),
            "leaf_value=" + " ".join(f"{x:.17g}" for x in values),
            "leaf_count=" + " ".join(str(max(1, int(c * total)))
                                     for c in cnt),
            "internal_value=" + " ".join("0" for _ in sf),
            "internal_count=" + " ".join(str(max(1, int(c * total)))
                                         for c in icnt),
            "shrinkage=1", ""]))
    names = " ".join(f"Column_{j}" for j in range(F))
    infos = " ".join(f"[{e[0]:.17g}:{e[-1]:.17g}]" for e in edges)
    head = "\n".join(["tree", "version=v2", "num_class=1",
                      "num_tree_per_iteration=1", "label_index=0",
                      f"max_feature_idx={F - 1}", "objective=binary sigmoid:1",
                      f"feature_names={names}", f"feature_infos={infos}",
                      "tree_sizes=" + " ".join(str(len(b) + 1)
                                               for b in blocks), ""])
    return head + "\n" + "\n".join(blocks) + "\nend of trees\n"
