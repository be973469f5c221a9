"""Plain reference of leaf-wise tree growth, and the judge of grown trees.

The configuration's algorithm (LightGBM v2.1, serial learner): a tree
starts from one leaf holding every row; each round the leaf whose best
split gains most is split, until ``num_leaves`` leaves or no leaf has a
split of positive gain.  For a leaf with gradient sum G and hessian sum
H, a split into (GL, HL) and (GR, HR) gains

    GL^2 / (HL + l2) + GR^2 / (HR + l2) - G^2 / (H + l2),

over thresholds b of one feature (rows with bin <= b go left), each child
keeping at least ``min_data_in_leaf`` rows and ``min_sum_hessian_in_leaf``
hessian.  A leaf's value is -G / (H + l2) times the learning rate.

:func:`judge` holds grown trees to that algorithm.  It routes the raw
rows through each tree's thresholds, works out the exact (float64)
gradients at the scores that the earlier trees' exact leaf values give,
and reads two numbers for each tree:

- split regret: at each split, how far the best split of that node's
  rows gains more than the split taken, over the larger of the node's
  best gain and the median node's;
- leaf gap: how far each leaf value lies from -G/(H + l2) * lr on the
  leaf's rows, over the larger of that value and the median leaf's; the
  largest over the trees' leaves, and their median;
- leaf shortfall: how many leaves a tree lacks of ``num_leaves`` while
  one of its leaves still has a split of positive gain;
- frontier regret: how far an unsplit leaf's best split gains more than
  a split taken after that leaf was made, over the larger of the leaf's
  best gain and the median node's.

The frontier is split in batched best-first order: each round splits
the leaves whose best split gains most, within the leaf budget (strict
best-first is the case of one split a round).  A leaf left unsplit was
passed over in every later round, so each split taken in a later round
gains at least as much.  Internal nodes are numbered in the order they
were split, a round's nodes together; a node's round is taken as the
least that this order and its parent's round allow (a round starts
where a node's parent was split in the round before), which can merge
two real rounds and so leaves a comparison out, never adds one.

:func:`grow` is the reference grower.  It serves as the control: the
same algorithm on gradients held at a given lower precision.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from . import model_text


def precision_cast(g: torch.Tensor, h: torch.Tensor, mode: str):
    """(g, h) held at ``mode``: "exact" (float64) or "tf32" (a 10-bit
    mantissa, rounded to nearest), returned in float64."""
    if mode == "exact":
        return g, h
    if mode == "tf32":
        def tf32(x):
            b = x.to(torch.float32).view(torch.int32)
            b = (b + 0x1000) & ~0x1FFF
            return b.view(torch.float32).to(torch.float64)
        return tf32(g), tf32(h)
    raise ValueError(f"unknown precision {mode!r}")


def _hist(bins: torch.Tensor, rows: torch.Tensor, node: torch.Tensor,
          nodes: int, g: torch.Tensor, h: torch.Tensor, B: int,
          block: int = 1 << 21) -> torch.Tensor:
    """(nodes, F, B, 3) float64 sums of g, h and 1 over ``rows``, each
    row into its ``node``."""
    F = bins.shape[1]
    out = torch.zeros(3, nodes * F * B, dtype=torch.float64,
                      device=bins.device)
    off = (torch.arange(F, device=bins.device) * B)[None, :]
    for a in range(0, rows.numel(), block):
        r = rows[a:a + block]
        key = (node[a:a + block, None] * (F * B) + off
               + bins[r].long()).reshape(-1)
        for c, w in enumerate((g[r], h[r], None)):
            if w is None:
                out[c] += torch.bincount(key, minlength=nodes * F * B)
            else:
                out[c] += torch.bincount(
                    key, weights=w[:, None].expand(-1, F).reshape(-1),
                    minlength=nodes * F * B)
    return out.reshape(3, nodes, F, B).permute(1, 2, 3, 0)


def split_gains(hist: torch.Tensor, num_bin: torch.Tensor,
                cfg: Dict) -> torch.Tensor:
    """(nodes, F, B) gain of every threshold; -inf where a threshold is
    out of range or a child breaks a constraint."""
    l2 = float(cfg.get("lambda_l2", 0.0))
    cum = hist.cumsum(dim=2)
    tot = cum[:, :, -1:, :]
    gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
    gr, hr, cr = (tot[..., 0] - gl, tot[..., 1] - hl, tot[..., 2] - cl)
    G, H = tot[..., 0], tot[..., 1]
    gain = gl * gl / (hl + l2) + gr * gr / (hr + l2) - G * G / (H + l2)
    B = hist.shape[2]
    md = float(cfg["min_data_in_leaf"])
    mh = float(cfg["min_sum_hessian_in_leaf"])
    ok = ((torch.arange(B, device=hist.device)[None, None, :]
           <= (num_bin - 2)[None, :, None])
          & (cl >= md) & (cr >= md) & (hl >= mh) & (hr >= mh))
    return torch.where(ok, gain, -torch.inf)


def _median_floor(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x.abs(), x.abs().median())


def route_levels(X: torch.Tensor, tree: Dict[str, np.ndarray]):
    """Route every row of X through one tree: ([(rows, node) of each
    depth's rows still at internal nodes], (N,) leaf of each row)."""
    dev = X.device
    n = X.shape[0]
    levels = []
    leaf = torch.zeros(n, dtype=torch.long, device=dev)
    if tree["num_leaves"] <= 1:
        return levels, leaf
    sf = torch.as_tensor(tree["split_feature"], device=dev)
    thr = torch.as_tensor(tree["threshold"], device=dev)
    dt = torch.as_tensor(tree["decision_type"], device=dev)
    lc = torch.as_tensor(tree["left_child"], device=dev)
    rc = torch.as_tensor(tree["right_child"], device=dev)
    rows = torch.arange(n, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    while rows.numel():
        levels.append((rows, node))
        x = X[rows, sf[node]].to(torch.float64)
        nxt = torch.where(model_text._goes_left(x, thr[node], dt[node]),
                          lc[node], rc[node])
        done = nxt < 0
        leaf[rows[done]] = ~nxt[done]
        rows, node = rows[~done], nxt[~done]
    return levels, leaf


def node_rounds(tree: Dict[str, np.ndarray]):
    """((L-1,) round of each internal node, (L,) the internal node that
    made each leaf, -1 for a lone root): the least rounds that the
    node order and the parents allow (see the module's note)."""
    L = int(tree["num_leaves"])
    parent = np.full(max(L - 1, 0), -1, dtype=np.int64)
    maker = np.full(L, -1, dtype=np.int64)
    for i in range(L - 1):
        for c in (tree["left_child"][i], tree["right_child"][i]):
            if c >= 0:
                parent[c] = i
            else:
                maker[~c] = i
    rounds = np.zeros(max(L - 1, 0), dtype=np.int64)
    for i in range(1, L - 1):
        rounds[i] = max(rounds[i - 1], rounds[parent[i]] + 1)
    return rounds, maker


def judge(X: torch.Tensor, bins: torch.Tensor, bounds: List[np.ndarray],
          gradients: Callable, trees: List[Dict[str, np.ndarray]],
          cfg: Dict, init_score: float = 0.0) -> Dict[str, float]:
    """The worst split regret, leaf gap, leaf shortfall and frontier
    regret, and the median leaf gap, over ``trees``, grown in order from
    ``init_score`` on the rows X (float64) whose reference bins are
    ``bins`` under ``bounds``; ``gradients(score)`` gives the exact
    (grad, hess).  ``where`` names the worst split (tree, node), leaf
    (tree, leaf, rows, reference value, value) and unsplit leaf (tree,
    leaf, its best gain, the least gain taken after it)."""
    lr = float(cfg["learning_rate"])
    l2 = float(cfg.get("lambda_l2", 0.0))
    max_leaves = int(cfg["num_leaves"])
    dev = X.device
    B = max(len(b) for b in bounds)
    num_bin = torch.as_tensor([len(b) for b in bounds], device=dev)
    score = torch.full((X.shape[0],), float(init_score),
                       dtype=torch.float64, device=dev)
    all_rows = torch.arange(X.shape[0], device=dev)
    regret, gap, gaps = 0.0, 0.0, []
    shortfall, frontier = 0, 0.0
    where = {}
    for ti, t in enumerate(trees):
        g, h = gradients(score)
        levels, leaf = route_levels(X, t)
        L = t["num_leaves"]
        # the best split of every leaf as grown, on its rows
        open_gain = split_gains(_hist(bins, all_rows, leaf, L, g, h, B),
                                num_bin, cfg).flatten(1).amax(1)
        open_gain = torch.where(torch.isfinite(open_gain), open_gain, 0.0)
        if L < max_leaves and float(open_gain.max()) > 0.0:
            shortfall = max(shortfall, max_leaves - L)
        if L > 1:
            best = torch.empty(L - 1, dtype=torch.float64, device=dev)
            took = torch.empty_like(best)
            for rows, node in levels:
                ids, local = torch.unique(node, return_inverse=True)
                gains = split_gains(_hist(bins, rows, local, ids.numel(),
                                          g, h, B), num_bin, cfg)
                best[ids] = gains.flatten(1).amax(1)
                f = torch.as_tensor(t["split_feature"], device=dev)[ids]
                thr = torch.as_tensor(t["threshold"], device=dev)[ids]
                b = torch.stack([torch.searchsorted(
                    torch.as_tensor(bounds[int(fi)], device=dev), th[None])[0]
                    for fi, th in zip(f.tolist(), thr)]) if ids.numel() \
                    else f
                took[ids] = gains[torch.arange(ids.numel(), device=dev), f,
                                  b.clamp(max=B - 1)]
                # a threshold outside the range counts as no gain
                took[ids] = torch.where(torch.isfinite(took[ids]),
                                        took[ids], 0.0)
            best = torch.where(torch.isfinite(best), best, 0.0)
            r = (best - took) / _median_floor(best)
            if float(r.max()) > regret:
                regret = float(r.max())
                where["worst_split"] = [ti, int(r.argmax())]
            # each unsplit leaf against the least gain taken in a later
            # round than the one that made it
            rounds, maker = node_rounds(t)
            R = int(rounds[-1]) + 1
            rd = torch.as_tensor(rounds, device=dev)
            least = torch.full((R + 1,), torch.inf, dtype=torch.float64,
                               device=dev).scatter_reduce(
                0, rd, took, "amin")
            later = torch.flip(torch.cummin(torch.flip(least, [0]), 0)
                               .values, [0])[1:]
            bar = later[rd[torch.as_tensor(maker, device=dev)]]
            floor = torch.maximum(open_gain.abs(), best.abs().median())
            fr = torch.where(torch.isfinite(bar),
                             (open_gain - bar) / floor, 0.0)
            if float(fr.max()) > frontier:
                k = int(fr.argmax())
                frontier = float(fr.max())
                where["worst_unsplit"] = [ti, k, float(open_gain[k]),
                                          float(bar[k])]
        G = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(
            0, leaf, g)
        H = torch.zeros(L, dtype=torch.float64, device=dev).index_add_(
            0, leaf, h)
        want = -G / (H + l2) * lr
        have = torch.as_tensor(t["leaf_value"], device=dev) \
            - (init_score if ti == 0 else 0.0)
        rel = (have - want).abs() / _median_floor(want)
        if float(rel.max()) > gap:
            k = int(rel.argmax())
            gap = float(rel.max())
            where["worst_leaf"] = [ti, k, int((leaf == k).sum()),
                                   float(want[k]), float(have[k])]
        gaps.append(rel)
        score = score + want[leaf]
    return {"split_regret": regret, "leaf_gap": gap,
            "leaf_gap_median": float(torch.cat(gaps).median()),
            "leaf_shortfall": shortfall, "frontier_regret": frontier,
            "where": where}


def grow(bins: torch.Tensor, bounds: List[np.ndarray], g: torch.Tensor,
         h: torch.Tensor, cfg: Dict) -> Dict[str, np.ndarray]:
    """One tree grown leaf-wise on (g, h) over the reference bins, as a
    model-text tree (thresholds are the bounds' values)."""
    dev = bins.device
    n, F = bins.shape
    B = max(len(b) for b in bounds)
    num_bin = torch.as_tensor([len(b) for b in bounds], device=dev)
    lr = float(cfg["learning_rate"])
    l2 = float(cfg.get("lambda_l2", 0.0))
    max_leaves = int(cfg["num_leaves"])
    leaf_of = torch.zeros(n, dtype=torch.long, device=dev)
    all_rows = torch.arange(n, device=dev)
    hists = [_hist(bins, all_rows, leaf_of, 1, g, h, B)[0]]

    def best_of(hist):
        gains = split_gains(hist[None], num_bin, cfg)[0]
        k = int(gains.flatten().argmax())
        return float(gains.flatten()[k]), k // B, k % B

    cand = [best_of(hists[0])]
    # node records: (leaf, feature, bin, gain); leaf -> its parent slot
    nodes: List[list] = []
    parent_slot = {0: None}
    while len(hists) < max_leaves:
        leaf = max(range(len(cand)), key=lambda i: cand[i][0])
        gain, f, b = cand[leaf]
        if not gain > 0.0:
            break
        new = len(hists)
        in_leaf = leaf_of == leaf
        right = in_leaf & (bins[:, f].long() > b)
        leaf_of[right] = new
        parent = hists[leaf]
        left_n = float(parent[f, :b + 1, 2].sum())
        small = leaf if left_n <= float(parent[0, :, 2].sum()) - left_n \
            else new
        rows = torch.nonzero(leaf_of == small)[:, 0]
        hs = _hist(bins, rows, torch.zeros_like(rows), 1, g, h, B)[0]
        hl, hr = (hs, parent - hs) if small == leaf else (parent - hs, hs)
        hists[leaf] = hl
        hists.append(hr)
        cand[leaf] = best_of(hl)
        cand.append(best_of(hr))
        slot = len(nodes)
        nodes.append([f, b, gain, ~leaf, ~new])
        p = parent_slot[leaf]
        if p is not None:
            nodes[p[0]][p[1]] = slot
        parent_slot[leaf] = (slot, 3)
        parent_slot[new] = (slot, 4)
    L = len(hists)
    G = torch.stack([x[0, :, 0].sum() for x in hists])
    H = torch.stack([x[0, :, 1].sum() for x in hists])
    counts = torch.stack([x[0, :, 2].sum() for x in hists])
    tree = {"num_leaves": L,
            "leaf_value": (-G / (H + l2) * lr).cpu().numpy(),
            "leaf_count": counts.cpu().numpy().astype(np.int64)}
    m = len(nodes)
    tree["split_feature"] = np.array([r[0] for r in nodes], dtype=np.int64)
    tree["threshold"] = np.array([bounds[r[0]][r[1]] for r in nodes])
    tree["split_gain"] = np.array([r[2] for r in nodes])
    tree["decision_type"] = np.zeros(m, dtype=np.int64)
    tree["left_child"] = np.array([r[3] for r in nodes], dtype=np.int64)
    tree["right_child"] = np.array([r[4] for r in nodes], dtype=np.int64)
    tree["internal_count"] = np.zeros(m, dtype=np.int64)
    return tree
