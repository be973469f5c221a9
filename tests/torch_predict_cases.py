"""Ensembles and rows for the tests of kernel C (the ensemble level
descent), shared by tests/test_torch_predict_records.py (CPU, against
the JAX package) and tests/test_torch_cuda.py (the card, no jax).

Every tree is a port ``Tree`` made from a numpy seed: leaf-wise grown
trees like the bench's (one random leaf split at a time), complete
trees, stumps; splits with every missing type, both default
directions, +-inf thresholds and categorical bitsets of two words
(categories up to 40)."""
import numpy as np

from lightgbm_tpu_torch.tree import Tree, _construct_bitset, flatten_ensemble

CAT_FEATURES = (3, 7)


def _split(rng, t, i, F, cats):
    f = int(rng.randint(0, F))
    t.split_feature[i] = f
    if f in cats and rng.rand() < 0.7:
        words = _construct_bitset(
            sorted(set(rng.randint(0, 40, 6).tolist())))
        t.threshold[i] = t.num_cat
        t.num_cat += 1
        t.cat_boundaries.append(t.cat_boundaries[-1] + len(words))
        t.cat_threshold.extend(words)
        t.decision_type[i] = 1
    else:
        t.threshold[i] = (np.inf if rng.rand() < 0.03 else
                          -np.inf if rng.rand() < 0.03 else
                          float(rng.randn()))
        t.decision_type[i] = ((2 if rng.rand() < 0.5 else 0)
                              | (int(rng.randint(0, 3)) << 2))


def leafwise_tree(rng, leaves, F, cats=CAT_FEATURES):
    """A tree grown leaf by leaf: split i turns a random leaf l into node
    i with l on its left and the new leaf i + 1 on its right."""
    t = Tree(leaves)
    where = {0: None}                    # leaf -> (its parent node, side)
    for i in range(leaves - 1):
        leaf, new = int(rng.randint(0, i + 1)), i + 1
        if where[leaf] is not None:
            node, side = where[leaf]
            (t.left_child if side else t.right_child)[node] = i
        t.left_child[i] = -leaf - 1
        t.right_child[i] = -new - 1
        where[leaf], where[new] = (i, True), (i, False)
        _split(rng, t, i, F, cats)
    t.leaf_value = rng.randn(leaves) * 0.1
    return t


def complete_tree(rng, depth, F, cats=CAT_FEATURES):
    m = 2 ** depth - 1
    t = Tree(m + 1)
    for i in range(m):
        lc, rc = 2 * i + 1, 2 * i + 2
        t.left_child[i] = lc if lc < m else -(lc - m) - 1
        t.right_child[i] = rc if rc < m else -(rc - m) - 1
        _split(rng, t, i, F, cats)
    t.leaf_value = rng.randn(m + 1) * 0.1
    return t


def stump(value):
    t = Tree(1)
    t.leaf_value[0] = value
    return t


#: name -> (trees, classes) from a RandomState, features, categorical
#: features; the card tests run every one, the CPU tests the smaller
#: ones against the JAX package too
ENSEMBLES = {
    "bench-like": (lambda rng: ([leafwise_tree(rng, 255, 28)
                                 for _ in range(10)], 1), 28, CAT_FEATURES),
    "500 trees": (lambda rng: ([complete_tree(rng, 8, 28)
                                for _ in range(499)] + [stump(0.25)], 1),
                  28, CAT_FEATURES),
    "K=3": (lambda rng: ([complete_tree(rng, 6, 28) for _ in range(29)]
                         + [stump(-0.5)], 3), 28, CAT_FEATURES),
    # 100 trees a class: the shared tier's chunks end inside a class
    "K=5, 500 trees": (lambda rng: ([complete_tree(rng, 8, 28)
                                     for _ in range(499)] + [stump(-0.5)],
                                    5), 28, CAT_FEATURES),
    "categorical": (lambda rng: ([complete_tree(rng, 5, 8, cats=(0, 3, 7))
                                  for _ in range(6)], 1), 8, (0, 3, 7)),
    "stumps only": (lambda rng: ([stump(v) for v in (0.5, -1.25, 3.0)], 1),
                    28, CAT_FEATURES),
    # past the walk record's 16-bit child codes: flat child ids
    "wide tree": (lambda rng: ([leafwise_tree(rng, 33000, 12),
                                stump(1.0)], 1), 12, CAT_FEATURES),
}


def ensemble(name, seed=0):
    """(flatten_ensemble dict without ``depth``, depth, trees, features,
    categorical features) of ENSEMBLES[name]."""
    make, F, cats = ENSEMBLES[name]
    trees, k = make(np.random.RandomState(seed))
    flat = flatten_ensemble(trees, k)
    depth = int(flat.pop("depth"))
    return flat, depth, trees, F, cats


def rows(n, F=28, seed=1, cats=CAT_FEATURES):
    """(n, F) float64 rows: normal values with 5% NaN, 5% zeros, 1%
    +-inf, and integer categories in [-1, 45) on the categorical
    features."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    X[rng.rand(n, F) < 0.05] = 0.0
    X[rng.rand(n, F) < 0.01] = np.inf * np.sign(rng.randn())
    for c in cats:
        if c < F:
            X[:, c] = rng.randint(-1, 45, n)
    return X
