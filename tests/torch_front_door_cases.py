"""Shared inputs of the front-door tests (tests/test_torch_engine.py,
test_torch_continue.py, test_torch_cv.py): tests/test_torch_train.py's
main-path parameters and data, both packages' datasets built from them,
the tree comparison with that file's tolerances, and where two trees
part."""
import numpy as np

#: tests/test_torch_train.py's main path: int8 gradients, fused_tiled
PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
          "verbose": -1, "min_data_in_leaf": 5, "quantized_grad": True,
          "hist_compute_dtype": "bfloat16",
          "metric": ["auc", "binary_logloss"]}
#: the JAX side runs its Pallas kernels in interpret mode on the CPU
JAX = {"force_pallas_interpret": True, "compile_cache_dir": ""}
#: the port runs its kernels' plain versions on the CPU
PORT = {"device": "cpu"}


def data(n, seed):
    """tests/test_torch_train.py's rows: NaNs, zeros, a noisy label."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 8)
    X[rng.rand(n, 8) < 0.05] = np.nan
    X[:, 3] = np.where(rng.rand(n) < 0.3, 0.0, X[:, 3])
    y = (X[:, 0] - 0.5 * np.nan_to_num(X[:, 1]) + 0.3 * rng.randn(n)
         > 0).astype(float)
    return X, y


def train_rows():
    return data(4000, 0)


def valid_rows():
    """1,000 held-out rows with their labels, and labels drawn from a
    seed independently of X (a validation set that gets worse)."""
    Xv, yv = data(1000, 1)
    return Xv, yv, np.random.RandomState(5).randint(0, 2, 1000).astype(float)


def datasets(pkg, free_raw_data=True):
    """``pkg``'s training set and its two aligned validation sets."""
    X, y = train_rows()
    Xv, yv, noise = valid_rows()
    d = pkg.Dataset(X, label=y, free_raw_data=free_raw_data)
    return d, [pkg.Dataset(Xv, label=yv, reference=d),
               pkg.Dataset(Xv, label=noise, reference=d)]


def parting_node(jt, tt):
    """The first node at which two trees split on another feature or
    threshold, and the rows of ``X`` that reach it (the path to it, which
    both trees share, read from ``jt``): (node, function X -> mask)."""
    node = int(np.nonzero((jt.split_feature != tt.split_feature)
                          | (jt.threshold != tt.threshold))[0][0])

    def rows(X):
        mask = np.ones(len(X), bool)
        child = node
        while child:
            parent = np.nonzero((jt.left_child == child)
                                | (jt.right_child == child))[0][0]
            left = X[:, jt.split_feature[parent]] <= jt.threshold[parent]
            mask &= left if jt.left_child[parent] == child else ~left
            child = parent
        return mask
    return node, rows


def assert_same_trees(jmodels, tmodels, of_largest=False):
    """tests/test_torch_train.py's tree check: structure equal, leaf
    values within 1e-5 relative, the default-left bit not compared.
    With ``of_largest`` the leaves are held within 1e-5 of the tree's
    largest leaf, tests/test_torch_objectives_train.py's tolerance for
    trees whose first leaves already carry the JAX package's FMAs."""
    assert len(jmodels) == len(tmodels)
    for jt, tt in zip(jmodels, tmodels):
        assert jt.num_leaves == tt.num_leaves
        for f in ("split_feature", "threshold", "left_child",
                  "right_child", "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), f)
        np.testing.assert_array_equal(jt.decision_type & ~2,
                                      tt.decision_type & ~2)
        scale = float(np.abs(jt.leaf_value).max()) if of_largest else 1e-4
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value,
                                   rtol=1e-5, atol=1e-5 * scale)


def assert_same_evals(jev, tev):
    """Equal datasets, metrics and lengths; values within 1e-5."""
    assert list(jev) == list(tev)
    for d in jev:
        assert list(jev[d]) == list(tev[d])
        for m in jev[d]:
            assert len(jev[d][m]) == len(tev[d][m]), (d, m)
            np.testing.assert_allclose(tev[d][m], jev[d][m], rtol=1e-5,
                                       err_msg=f"{d} {m}")


def error_rate(scores, train_set):
    """A feval: the training rows' error at p = 0.5."""
    p = 1.0 / (1.0 + np.exp(-np.asarray(scores, np.float64)))
    return "error", float(np.mean((p > 0.5) != train_set.get_label())), False


def logloss_grad(scores, train_set):
    """A numpy fobj: the binary log loss's gradient and hessian, in f32
    (at score 0 exactly -0.5/+0.5 and 0.25)."""
    s = np.asarray(scores, np.float32)
    p = (np.float32(1.0) / (np.float32(1.0) + np.exp(-s))).astype(np.float32)
    y = train_set.get_label().astype(np.float32)
    return p - y, p * (np.float32(1.0) - p)
