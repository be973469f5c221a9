"""The port's host surface against the JAX package on the CPU: the
sklearn estimators (tests/test_sklearn.py's fast cases), the flat
``LGBM_*`` C API (tests/test_capi.py's flows, and the file, push-rows
and sampled-column flows), the plotting helpers, and ``python -m
lightgbm_tpu_torch`` in a process of its own."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from sklearn.datasets import load_breast_cancer, make_regression

import lightgbm_tpu as J
import lightgbm_tpu.capi as jcapi
import lightgbm_tpu_torch as T
import lightgbm_tpu_torch.capi as tcapi
from torch_front_door_cases import parting_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"compile_cache_dir": ""}
PORT = {"device": "cpu"}


def close(a, b, of_largest=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=of_largest * max(1.0, np.abs(b).max()))


# ---------------------------------------------------------------------------
# sklearn
# ---------------------------------------------------------------------------
def fit_both(cls_name, X, y, **kw):
    out = []
    for pkg, side in ((J, JAX), (T, PORT)):
        m = getattr(pkg, cls_name)(silent=True, **side, **kw)
        out.append(m.fit(X, y))
    return out


def same_as_jax_params(jm, tm, X, y, rounds, first_tree=True, **fit):
    """The port's estimator trains what the port's lgb.train trains
    from the JAX estimator's parameters, text for text, and its first
    tree is the JAX estimator's.  (Later trees may part at ties that
    only rounding ranks: ROADMAP.md queue 3.)"""
    p = {k: v for k, v in jm._build_params().items()
         if k not in JAX}
    want = T.train(dict(p, **PORT), T.Dataset(X, label=y, **fit), rounds)
    assert tm.booster_.model_to_string() == want.model_to_string()
    if not first_tree:
        return
    jt, tt = jm.booster_.models[0], tm.booster_.models[0]
    np.testing.assert_array_equal(tt.split_feature, jt.split_feature)
    np.testing.assert_array_equal(tt.threshold, jt.threshold)
    close(tt.leaf_value, jt.leaf_value)


def test_regressor_equals_jax():
    X, y = make_regression(n_samples=400, n_features=8, noise=5.0,
                           random_state=0)
    jm, tm = fit_both("LGBMRegressor", X, y, n_estimators=10)
    same_as_jax_params(jm, tm, X, y, 10)
    close(tm.predict(X), jm.predict(X), 1e-4)
    assert tm.n_features_ == jm.n_features_ == 8
    assert tm.objective_ == jm.objective_ == "regression"


def test_classifier_binary_equals_jax():
    X, y = load_breast_cancer(return_X_y=True)
    jm, tm = fit_both("LGBMClassifier", X, y, n_estimators=10)
    same_as_jax_params(jm, tm, X, y, 10)
    # the second trees part at an exact tie that only rounding ranks:
    # rows of one label and one first-tree score share a gradient and a
    # hessian, and both splits send as many rows of each kind left
    jt, tt = jm.booster_.models[1], tm.booster_.models[1]
    part, node_rows = parting_node(jt, tt)
    at = node_rows(X)
    assert at.sum() == jt.internal_count[part] == tt.internal_count[part]
    score = tm.booster_.predict(X, raw_score=True, num_iteration=1)
    kinds = [(y[i], score[i]) for i in np.nonzero(at)[0]]
    sent = [sorted(k for k, left in zip(kinds, X[at, t.split_feature[part]]
                                        <= t.threshold[part]) if left)
            for t in (jt, tt)]
    assert sent[0] == sent[1] and 0 < len(sent[0]) < len(kinds)
    tp = tm.predict_proba(X)
    assert tp.shape == (len(y), 2)
    # the positive column is booster_.predict bit for bit
    assert tp[:, 1].tobytes() == tm.booster_.predict(X).tobytes()
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    assert (tm.predict(X) == y).mean() > 0.95
    assert abs((tm.predict(X) == y).mean() - (jm.predict(X) == y).mean()) \
        < 0.01
    assert tm.apply(X).shape == (len(y), 10)


def test_classifier_string_labels_and_eval_set():
    X, y = load_breast_cancer(return_X_y=True)
    ys = np.where(y > 0, "pos", "neg")
    res = []
    for pkg, side in ((J, JAX), (T, PORT)):
        m = pkg.LGBMClassifier(n_estimators=8, num_leaves=15, verbose=-1,
                               **side)
        m.fit(X, ys, eval_set=[(X[:200], ys[:200])], verbose=False)
        res.append(m)
    jm, tm = res
    same_as_jax_params(jm, tm, X, (ys == "pos").astype(float), 8)
    assert set(tm.predict(X)) <= {"pos", "neg"}
    assert list(tm.evals_result_) == list(jm.evals_result_)
    assert list(tm.best_score_) == list(jm.best_score_)
    assert tm.objective_ == "binary"


def test_ranker_equals_jax():
    rng = np.random.RandomState(0)
    X = rng.rand(600, 5)
    rel = (X[:, 0] * 4).astype(int).clip(0, 3)
    res = []
    for pkg, side in ((J, JAX), (T, PORT)):
        m = pkg.LGBMRanker(n_estimators=20, silent=True,
                           min_child_samples=1, **side)
        res.append(m.fit(X, rel, group=[20] * 30))
    # (lambdarank sums its pairs in another order: its first tree may
    # part from the JAX package's too, tests/test_torch_lambdarank.py)
    same_as_jax_params(res[0], res[1], X, rel, 20, first_tree=False,
                       group=[20] * 30)
    s = res[1].predict(X)
    assert s[rel == 3].mean() > s[rel == 0].mean()
    with pytest.raises(ValueError, match="group"):
        T.LGBMRanker(device="cpu").fit(X, rel)


def test_sklearn_contract_and_pickle():
    from sklearn.base import clone, is_classifier, is_regressor
    from sklearn.utils.validation import check_is_fitted
    reg = T.LGBMRegressor(n_estimators=5, num_leaves=7, device="cpu")
    clf = T.LGBMClassifier(n_estimators=5, num_leaves=7, device="cpu")
    assert is_regressor(reg) and is_classifier(clf)
    reg2 = clone(reg).set_params(n_estimators=3)
    assert reg2.get_params()["n_estimators"] == 3
    assert reg.get_params()["n_estimators"] == 5
    rng = np.random.RandomState(0)
    X = rng.randn(120, 4)
    reg.fit(X, X[:, 0] * 2.0 + rng.randn(120) * 0.1)
    check_is_fitted(reg)
    clf.fit(X, (X[:, 0] > 0).astype(int))
    np.testing.assert_allclose(clf.predict_proba(X).sum(axis=1), 1.0)
    b = pickle.loads(pickle.dumps(clf.booster_))
    assert b.predict(X[:5]).tobytes() == clf.booster_.predict(X[:5]).tobytes()


def test_sklearn_device_rule():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X = np.random.RandomState(0).randn(100, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.LGBMRegressor(n_estimators=2).fit(X, X[:, 0])


# ---------------------------------------------------------------------------
# the C API
# ---------------------------------------------------------------------------
def _mk_data(rng, n=500, f=5):
    X = rng.randn(n, f)
    return X, (X[:, 0] - X[:, 1] > 0).astype(np.float64)


def ok(rc):
    assert rc == 0, tcapi.LGBM_GetLastError()


def test_capi_lifecycle_equals_jax_train(tmp_path):
    X, y = _mk_data(np.random.RandomState(0))
    dh, bh = [None], [None]
    ok(tcapi.LGBM_DatasetCreateFromMat(X, "max_bin=31", None, dh))
    ok(tcapi.LGBM_DatasetSetField(dh[0], "label", y))
    nd, nf = [None], [None]
    ok(tcapi.LGBM_DatasetGetNumData(dh[0], nd))
    ok(tcapi.LGBM_DatasetGetNumFeature(dh[0], nf))
    assert (nd[0], nf[0]) == (500, 5)
    params = "objective=binary num_leaves=15 metric=binary_logloss verbose=-1"
    ok(tcapi.LGBM_BoosterCreate(dh[0], params + " device=cpu", bh))
    for _ in range(10):
        ok(tcapi.LGBM_BoosterUpdateOneIter(bh[0], [0]))
    it, ev = [None], [None]
    ok(tcapi.LGBM_BoosterGetCurrentIteration(bh[0], it))
    ok(tcapi.LGBM_BoosterGetEval(bh[0], 0, ev))
    assert it[0] == 10 and ev[0][0] < 0.6
    # (the booster's parameters construct the dataset: max_bin 255)
    jb = J.train(dict(tcapi._parse_params(params), **JAX),
                 J.Dataset(X, label=y), 10)
    po = [None]
    ok(tcapi.LGBM_BoosterPredictForMat(bh[0], X[:32], 0, -1, po))
    close(po[0], jb.predict(X[:32]))
    path = str(tmp_path / "capi_model.txt")
    ok(tcapi.LGBM_BoosterSaveModel(bh[0], -1, path))
    ni, bh2, po2 = [None], [None], [None]
    ok(tcapi.LGBM_BoosterCreateFromModelfile(path, ni, bh2))
    ok(tcapi.LGBM_BoosterResetParameter(bh2[0], "device=cpu"))
    ok(tcapi.LGBM_BoosterPredictForMat(bh2[0], X[:32], 0, -1, po2))
    np.testing.assert_allclose(po[0], po2[0], rtol=1e-6)
    pl, pc = [None], [None]
    ok(tcapi.LGBM_BoosterPredictForMat(bh[0], X[:8], 2, -1, pl))
    ok(tcapi.LGBM_BoosterPredictForMat(bh[0], X[:8], 3, -1, pc))
    assert pl[0].shape == (8, 10) and pc[0].shape == (8, 6)
    ok(tcapi.LGBM_BoosterFree(bh[0]))
    ok(tcapi.LGBM_DatasetFree(dh[0]))
    # the error convention
    assert tcapi.LGBM_BoosterCreate(999999, "objective=binary", [None]) == -1
    assert "handle" in tcapi.LGBM_GetLastError()
    assert tcapi.LGBM_NetworkInit("a,b", 1, 1, 2) == -1
    assert "distributed" in tcapi.LGBM_GetLastError()


def test_capi_custom_gradients_and_getters(tmp_path):
    X, y = _mk_data(np.random.RandomState(1))
    dh, bh = [None], [None]
    ok(tcapi.LGBM_DatasetCreateFromMat(X, "verbose=-1", None, dh))
    ok(tcapi.LGBM_DatasetSetField(dh[0], "label", y))
    names = [f"f{i}" for i in range(5)]
    ok(tcapi.LGBM_DatasetSetFeatureNames(dh[0], names, 5))
    got, nlen = [], [0]
    ok(tcapi.LGBM_DatasetGetFeatureNames(dh[0], got, nlen))
    assert got == names
    sub = [None]
    ok(tcapi.LGBM_DatasetGetSubset(dh[0], np.arange(200), 200, "verbose=-1",
                                   sub))
    ok(tcapi.LGBM_DatasetGetNumData(sub[0], nlen))
    assert nlen[0] == 200
    params = "objective=binary num_leaves=7 verbose=-1 device=cpu"
    ok(tcapi.LGBM_BoosterCreate(dh[0], params, bh))
    grad = np.float32(0.5) - y.astype(np.float32)
    ok(tcapi.LGBM_BoosterUpdateOneIterCustom(bh[0], grad,
                                             np.full(500, 0.25, np.float32),
                                             [0]))
    for _ in range(3):
        ok(tcapi.LGBM_BoosterUpdateOneIter(bh[0], [None]))
    out_len, buf = [0], np.zeros(500)
    ok(tcapi.LGBM_BoosterGetPredict(bh[0], 0, out_len, buf))
    assert out_len[0] == 500 and ((buf >= 0) & (buf <= 1)).all()
    nm, v, v2 = [0], [0.0], [0.0]
    ok(tcapi.LGBM_BoosterNumberOfTotalModel(bh[0], nm))
    assert nm[0] == 4
    ok(tcapi.LGBM_BoosterGetLeafValue(bh[0], 0, 0, v))
    ok(tcapi.LGBM_BoosterSetLeafValue(bh[0], 0, 0, v[0] + 0.25))
    ok(tcapi.LGBM_BoosterGetLeafValue(bh[0], 0, 0, v2))
    assert abs(v2[0] - v[0] - 0.25) < 1e-12
    bh2 = [None]
    ok(tcapi.LGBM_BoosterCreate(dh[0], params, bh2))
    for _ in range(2):
        ok(tcapi.LGBM_BoosterUpdateOneIter(bh2[0], [None]))
    ok(tcapi.LGBM_BoosterMerge(bh[0], bh2[0]))
    ok(tcapi.LGBM_BoosterNumberOfTotalModel(bh[0], nm))
    assert nm[0] == 6
    ok(tcapi.LGBM_BoosterResetParameter(bh[0], "learning_rate=0.05"))
    fn = tmp_path / "pred_in.csv"
    np.savetxt(fn, np.column_stack([y, X]), delimiter=",", fmt="%.6f")
    outfn = tmp_path / "pred_out.tsv"
    ok(tcapi.LGBM_BoosterPredictForFile(bh[0], str(fn), 0, 0, -1,
                                        "label_column=0", str(outfn)))
    pm = [None]
    ok(tcapi.LGBM_BoosterPredictForMat(
        bh[0], np.loadtxt(fn, delimiter=",")[:, 1:], 0, -1, pm))
    assert open(outfn).read().splitlines() == [f"{p:g}" for p in pm[0]]


def test_capi_reference_push_reset_and_csc():
    from scipy import sparse as sp
    rng = np.random.RandomState(2)
    X, y = _mk_data(rng, 600, 5)
    assert tcapi.LGBM_SetLastError("embedder message") == 0
    assert tcapi.LGBM_GetLastError() == "embedder message"
    dh, dh2 = [None], [None]
    ok(tcapi.LGBM_DatasetCreateFromMat(X, "max_bin=31", None, dh))
    ok(tcapi.LGBM_DatasetSetField(dh[0], "label", y))
    X2, y2 = _mk_data(rng, 300, 5)
    ok(tcapi.LGBM_DatasetCreateByReference(dh[0], 300, dh2))
    ok(tcapi.LGBM_DatasetPushRows(dh2[0], X2[:150], 150, 5, 0))
    ok(tcapi.LGBM_DatasetPushRows(dh2[0], X2[150:], 150, 5, 150))
    ok(tcapi.LGBM_DatasetSetField(dh2[0], "label", y2))
    pushed = tcapi._get(dh2[0]).construct()
    aligned = T.Dataset(X2, reference=tcapi._get(dh[0])).construct()
    assert pushed.group_bins.tobytes() == aligned.group_bins.tobytes()
    bh = [None]
    ok(tcapi.LGBM_BoosterCreate(dh[0], "objective=binary num_leaves=15 "
                                "verbose=-1 device=cpu", bh))
    for _ in range(8):
        ok(tcapi.LGBM_BoosterUpdateOneIter(bh[0], [0]))
    nf, names, nlen, out_len = [None], [None], [None], [None]
    ok(tcapi.LGBM_BoosterGetNumFeature(bh[0], nf))
    ok(tcapi.LGBM_BoosterGetFeatureNames(bh[0], names, nlen))
    assert nf[0] == 5 and names[0][0] == "Column_0"
    for ptype, per_row in ((0, 1), (2, 8), (3, 6)):
        ok(tcapi.LGBM_BoosterCalcNumPredict(bh[0], 32, ptype, -1, out_len))
        assert out_len[0] == 32 * per_row
    Xs = sp.csc_matrix(X[:64])
    pc, pm = [None], [None]
    ok(tcapi.LGBM_BoosterPredictForCSC(bh[0], Xs.indptr, Xs.indices,
                                       Xs.data, 64, 0, -1, pc))
    ok(tcapi.LGBM_BoosterPredictForMat(bh[0], X[:64], 0, -1, pm))
    np.testing.assert_allclose(pc[0], pm[0], rtol=1e-6)
    before, after, it = [None], [None], [None]
    ok(tcapi.LGBM_BoosterPredictForMat(bh[0], X[:16], 0, -1, before))
    dh3 = [None]
    Xn, yn = _mk_data(rng, 400, 5)
    ok(tcapi.LGBM_DatasetCreateFromMat(Xn, "max_bin=31", None, dh3))
    ok(tcapi.LGBM_DatasetSetField(dh3[0], "label", yn))
    ok(tcapi.LGBM_BoosterResetTrainingData(bh[0], dh3[0]))
    ok(tcapi.LGBM_BoosterPredictForMat(bh[0], X[:16], 0, -1, after))
    np.testing.assert_allclose(after[0], before[0], rtol=1e-5)
    ok(tcapi.LGBM_BoosterGetCurrentIteration(bh[0], it))
    assert it[0] == 8
    ok(tcapi.LGBM_BoosterUpdateOneIter(bh[0], [0]))
    ok(tcapi.LGBM_BoosterGetCurrentIteration(bh[0], it))
    assert it[0] == 9


def test_capi_file_and_sampled_column_flows_equal_jax(tmp_path):
    """LGBM_DatasetCreateFromFile -> BoosterCreate -> 3 UpdateOneIter
    is lgb.train on the same file; the sampled-column flow with pushed
    rows is the in-RAM construction, byte for byte, in both packages."""
    rng = np.random.RandomState(3)
    X, y = _mk_data(rng, 800, 6)
    path = str(tmp_path / "train.tsv")
    np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter="\t")
    params = "objective=binary num_leaves=7 max_bin=31 verbose=-1 device=cpu"
    dh, bh, text = [None], [None], [None]
    ok(tcapi.LGBM_DatasetCreateFromFile(path, params, None, dh))
    ok(tcapi.LGBM_BoosterCreate(dh[0], params, bh))
    for _ in range(3):
        ok(tcapi.LGBM_BoosterUpdateOneIter(bh[0], [0]))
    ok(tcapi.LGBM_BoosterSaveModelToString(bh[0], -1, text))
    p = tcapi._parse_params(params)
    want = T.train(p, T.Dataset(path, params=p), 3).model_to_string()
    assert text[0] == want
    # sampled columns + pushed rows, in both packages
    from lightgbm_tpu_torch.dataset import split_sample_columns
    vals, rows = split_sample_columns(X)
    cores = []
    for capi in (jcapi, tcapi):
        sh = [None]
        assert capi.LGBM_DatasetCreateFromSampledColumn(
            vals, rows, 6, [len(v) for v in vals], 800, 800, "max_bin=31",
            sh) == 0
        for s in range(0, 800, 256):
            assert capi.LGBM_DatasetPushRows(sh[0], X[s:s + 256],
                                             len(X[s:s + 256]), 6, s) == 0
        cores.append(capi._get(sh[0]).construct())
    ram = T.Dataset(X, params={"max_bin": 31}).construct()
    assert cores[1].group_bins.tobytes() == cores[0].group_bins.tobytes() \
        == ram.group_bins.tobytes()
    assert cores[1].feature_infos() == cores[0].feature_infos()


# ---------------------------------------------------------------------------
# plotting
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def both_boosters():
    X, y = _mk_data(np.random.RandomState(4), 600, 5)
    ev = ({}, {})
    bst = []
    for (pkg, side), rec in zip(((J, JAX), (T, PORT)), ev):
        d = pkg.Dataset(X, label=y)
        bst.append(pkg.train({"objective": "binary", "num_leaves": 7,
                              "verbose": -1, **side}, d, 5,
                             valid_sets=[d], evals_result=rec,
                             verbose_eval=False))
    # the port's model read by both packages: the same trees
    text = bst[1].model_to_string()
    return (J.Booster(model_str=text),
            T.Booster(model_str=text, params=PORT)), ev


def test_create_tree_digraph_source_equals_jax(both_boosters):
    (jb, tb), _ = both_boosters
    for i in range(3):
        for info in ([], ["split_gain", "internal_count", "leaf_count"]):
            assert T.create_tree_digraph(tb, i, show_info=info).source \
                == J.create_tree_digraph(jb, i, show_info=info).source


def test_plot_importance_and_metric_values_equal_jax(both_boosters):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    (jb, tb), (jev, tev) = both_boosters
    for kind in ("split", "gain"):
        ja = J.plot_importance(jb, importance_type=kind)
        ta = T.plot_importance(tb, importance_type=kind)
        assert [p.get_width() for p in ta.patches] \
            == [p.get_width() for p in ja.patches]
        assert [t.get_text() for t in ta.get_yticklabels()] \
            == [t.get_text() for t in ja.get_yticklabels()]
    ja, ta = J.plot_metric(jev), T.plot_metric(tev)
    assert len(ta.lines) == len(ja.lines) == 1
    np.testing.assert_array_equal(ta.lines[0].get_xdata(),
                                  ja.lines[0].get_xdata())
    close(ta.lines[0].get_ydata(), ja.lines[0].get_ydata())
    assert ta.get_ylabel() == ja.get_ylabel()
    plt.close("all")


def test_python_dash_m_trains_and_saves(tmp_path):
    """``python -m lightgbm_tpu_torch`` in a process of its own; its
    model predicts through the in-process CLI."""
    import lightgbm_tpu_torch.cli as tcli
    model = str(tmp_path / "m.txt")
    pred = str(tmp_path / "p.txt")
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                        "config=examples/binary_classification/train.conf",
                        "device=cpu", "num_trees=3", f"output_model={model}"],
                       cwd=REPO, capture_output=True, text=True, timeout=240,
                       # one thread beside the suite's own workers
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Finished training" in r.stderr
    assert T.Booster(model_file=model, params=PORT).num_trees() == 3
    assert tcli.run(["task=predict", "device=cpu", f"input_model={model}",
                     "data=" + os.path.join(
                         REPO, "examples/binary_classification/binary.test"),
                     f"output_result={pred}"]) == 0
    assert len(open(pred).read().splitlines()) == 2000
