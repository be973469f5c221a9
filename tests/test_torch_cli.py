"""The port's command line against the JAX package's on the CPU:
``train`` (3 trees, ``device=cpu``) on each ``examples/*/train.conf``,
then ``predict``, ``convert_model`` (the generated C++ compiled with
``g++`` and run) and ``refit`` on its model; the binary cache and
two-round loading from the command line; the device rule; and the
tasks the port refuses (``python -m lightgbm_tpu_torch`` runs in
tests/test_torch_surface.py).
The JAX package parses through ``np.loadtxt`` here (its native parser
is not correctly rounded; tests/test_torch_file_io.py)."""
import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

import lightgbm_tpu as J
import lightgbm_tpu.cli as jcli
import lightgbm_tpu.native  # noqa: F401  (J.native)
import lightgbm_tpu_torch as T
import lightgbm_tpu_torch.cli as tcli
from torch_front_door_cases import assert_same_trees, parting_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = ["binary_classification/train.conf", "regression/train.conf",
         "regression/train_dart.conf", "multiclass_classification/train.conf",
         "lambdarank/train.conf"]
JAX_ARGS = ["compile_cache_dir=", "verbose=-1"]
PORT_ARGS = ["device=cpu", "verbose=-1"]


@pytest.fixture(autouse=True)
def in_repo(monkeypatch):
    """The example confs name their data relative to the repo root; the
    JAX package parses through np.loadtxt."""
    monkeypatch.chdir(REPO)

    def off(*a, **k):
        raise RuntimeError("native parse off")
    monkeypatch.setattr(J.native.text_loader, "load_csv", off)


def conf_data(conf):
    params = tcli.parse_args([f"config=examples/{conf}"])
    return params["data"], params["valid_data"]


def run_both(tmp_path, args):
    """Run ``args`` through both CLIs; {package: output prefix}."""
    out = {}
    for name, run, extra in (("jax", jcli.run, JAX_ARGS),
                             ("port", tcli.run, PORT_ARGS)):
        prefix = str(tmp_path / name)
        argv = [a.replace("{out}", prefix) for a in args] + extra
        assert run(argv) == 0
        out[name] = prefix
    return out


def models(path, pkg):
    if pkg is J:
        return J.Booster(model_file=path).models
    return T.Booster(model_file=path, params={"device": "cpu"}).models


def header(path):
    with open(path) as f:
        return [ln for ln in f.read().split("\nTree=0")[0].splitlines()]


def compile_model(cpp_path, so_path):
    subprocess.check_call(["g++", "-O2", "-shared", "-fPIC", cpp_path, "-o",
                           so_path])
    lib = ctypes.CDLL(so_path)
    lib.PredictRaw.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2
    return lib


def predict_compiled(lib, X, k):
    out = np.zeros(k)
    got = np.zeros((len(X), k))
    for i in range(len(X)):
        row = np.ascontiguousarray(X[i], dtype=np.float64)
        lib.PredictRaw(row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        got[i] = out
    return got


def assert_parts_at_a_pure_leaf(jt, tt, X, y, num_class):
    """The first class-0 trees of the two packages part at a node whose
    rows all have label 0, so all share one gradient and hessian and the
    exact gain of every split there is 0: what each package gains there
    is f32 rounding, and the two round differently (the f32 histogram
    sums of the XLA dot and of torch.matmul add in different orders).
    The first iteration's gradients, hessians and root sums are the same
    bits in both packages."""
    import jax.numpy as jnp
    import torch
    from types import SimpleNamespace

    from lightgbm_tpu.objectives import MulticlassSoftmax as JSoftmax
    from lightgbm_tpu.ops.histogram import compute_leaf_totals
    from lightgbm_tpu_torch.objectives import MulticlassSoftmax as TSoftmax
    from lightgbm_tpu_torch.ops.histogram import compute_root_totals

    n = len(y)
    meta = SimpleNamespace(label=y, weight=None)
    cfg = {"objective": "multiclass", "num_class": num_class}
    jo = JSoftmax(J.Config.from_params(cfg))
    jo.init(meta, n)
    to = TSoftmax(T.Config.from_params(cfg))
    to.init(meta, n, torch.device("cpu"))
    jg, jh = (np.asarray(a) for a in jo.get_gradients(
        jnp.zeros((n, num_class), jnp.float32)))
    tg, th = (a.numpy() for a in to.get_gradients(
        torch.zeros((n, num_class))))
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(th, jh)
    g, h, c = tg[:, 0], th[:, 0], np.ones(n, np.float32)
    jroot = np.asarray(compute_leaf_totals(g, h, c, np.zeros(n, np.int32),
                                           1))[0]
    troot = compute_root_totals(*(torch.from_numpy(a) for a in (g, h, c)),
                                torch.ones(n, dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(troot, jroot)

    part, node_rows = parting_node(jt, tt)
    assert part > 0
    rows = node_rows(X)
    assert rows.sum() == jt.internal_count[part] == tt.internal_count[part]
    assert set(y[rows]) == {0.0}
    G = float(g[rows].astype(np.float64).sum())
    H = float(h[rows].astype(np.float64).sum())
    for gain in (jt.split_gain[part], tt.split_gain[part]):
        assert 0 < gain < 1e-5 * G * G / H


@pytest.mark.parametrize("conf", CONFS)
def test_train_predict_convert_refit_equal_jax(tmp_path, conf):
    data, valid = conf_data(conf)
    tr = run_both(tmp_path, [f"config=examples/{conf}", "num_trees=3",
                             "output_model={out}.model.txt"])
    jm, tm = tr["jax"] + ".model.txt", tr["port"] + ".model.txt"
    # the header but the parameter echo (the device key differs) and
    # the tree sizes (the leaves' last digits differ)
    def fixed(path):
        return [ln for ln in header(path)
                if not ln.startswith(("[", "tree_sizes="))]
    assert fixed(tm) == fixed(jm)
    if "multiclass" in conf:
        # the trees part where a leaf is pure and every split's gain is
        # rounding (ROADMAP.md queue 3): the port's CLI model is its
        # lgb.train's on the same rows, text for text
        rows = np.loadtxt(data, delimiter="\t")
        assert_parts_at_a_pure_leaf(models(jm, J)[0], models(tm, T)[0],
                                    rows[:, 1:], rows[:, 0], 5)
        p = tcli.parse_args([f"config=examples/{conf}", "device=cpu",
                             "num_trees=3"])
        p = {k: v for k, v in p.items() if k not in (
            "config", "task", "data", "valid_data", "output_model")}
        bst = T.train(p, T.Dataset(rows[:, 1:], label=rows[:, 0]), 3,
                      verbose_eval=False)
        assert open(tm).read().split("\nTree=0", 1)[1] \
            == bst.model_to_string().split("\nTree=0", 1)[1]
    else:
        assert_same_trees(models(jm, J), models(tm, T), of_largest=True)

    # task=predict on the held-out file, each package on its own model
    for name, run, extra, model in (("jax", jcli.run, JAX_ARGS, jm),
                                    ("port", tcli.run, PORT_ARGS, tm)):
        assert run(["task=predict", f"data={valid}", f"input_model={model}",
                    f"output_result={tmp_path}/{name}.pred"] + extra) == 0
    jlines = open(f"{tmp_path}/jax.pred").read().splitlines()
    tlines = open(f"{tmp_path}/port.pred").read().splitlines()
    assert len(tlines) == len(jlines)
    jv = np.array([[float(v) for v in ln.split("\t")] for ln in jlines])
    tv = np.array([[float(v) for v in ln.split("\t")] for ln in tlines])
    # %g keeps 6 digits; the leaves agree within 1e-5 of the largest
    if "multiclass" in conf:
        # the rows the flipped split routes apart move every class's
        # probability (6% of the values, by at most 0.0026)
        off = np.abs(tv - jv) > 2e-5 * (1 + np.abs(jv))
        assert off.mean() < 0.1 and np.abs(tv - jv).max() < 5e-3
    else:
        np.testing.assert_allclose(tv, jv, rtol=2e-5, atol=2e-5)
    # and the port's lines are its Booster.predict in %g
    bst = T.Booster(model_file=tm, params={"device": "cpu"})
    X = T.data_loader.load_file(valid, T.Config())[0]
    want = np.asarray(bst.predict(X)).reshape(len(X), -1)
    assert tlines == ["\t".join(f"{v:g}" for v in row) for row in want]

    # task=convert_model: the C++ equals the port's raw scores
    cpp = str(tmp_path / "model.cpp")
    assert tcli.run(["task=convert_model", f"input_model={tm}",
                     f"convert_model={cpp}"] + PORT_ARGS) == 0
    lib = compile_model(cpp, str(tmp_path / "model.so"))
    k = bst.num_tree_per_iteration
    got = predict_compiled(lib, X[:300], k)
    raw = np.asarray(bst.predict(X[:300], raw_score=True, device=False))
    np.testing.assert_allclose(got, raw.reshape(300, k), rtol=0, atol=1e-10)

    # task=refit on the training file, both packages on the port's
    # model: the same trees, refitted leaves
    refit = ["task=refit", f"data={data}", f"input_model={tm}",
             "output_model={out}.refit.txt"]
    if "lambdarank" in conf:
        # neither package's refit takes query groups
        msgs = []
        for run, extra, out in ((jcli.run, JAX_ARGS, tr["jax"]),
                                (tcli.run, PORT_ARGS, tr["port"])):
            with pytest.raises(Exception) as e:
                run([a.replace("{out}", out) for a in refit] + extra)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] == "Lambdarank tasks require query " \
            "information"
        return
    ref = run_both(tmp_path, refit)
    jr, trf = models(ref["jax"] + ".refit.txt", J), \
        models(ref["port"] + ".refit.txt", T)
    for a, b in zip(jr, trf):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5 * np.abs(a.leaf_value).max())


def test_binary_cache_and_two_round_from_the_cli(tmp_path):
    """is_save_binary_file writes <data>.bin at load time; training from
    the cache, and two-round streaming, give the in-RAM model."""
    import shutil
    data = str(tmp_path / "binary.train")
    shutil.copy("examples/binary_classification/binary.train", data)
    base = ["config=examples/binary_classification/train.conf",
            "num_trees=3", "valid_data="] + PORT_ARGS
    texts = {}
    for label, extra in (("ram", ["is_save_binary_file=true"]),
                         ("cache", [f"data={data}.bin"]),
                         ("two_round", ["use_two_round_loading=true",
                                        "streaming_chunk_rows=777"])):
        out = str(tmp_path / f"{label}.txt")
        assert tcli.run(base + [f"data={data}", f"output_model={out}"]
                        + extra) == 0
        texts[label] = open(out).read().split("\nTree=0", 1)[1]
        if label == "ram":
            assert os.path.exists(data + ".bin")
    assert texts["cache"] == texts["ram"] == texts["two_round"]


def test_cli_device_rule_and_refusals(tmp_path):
    conf = "config=examples/binary_classification/train.conf"
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.run([conf, "num_trees=1",
                      f"output_model={tmp_path}/m.txt"])
    with pytest.raises(T.LightGBMError, match="task=serve"):
        tcli.run(["task=serve", "input_model=x.txt", "device=cpu"])
    with pytest.raises(T.LightGBMError, match="num_machines"):
        tcli.run([conf, "num_machines=2", "device=cpu"])
    # the parallel-learning example asks for the data-parallel learner,
    # which the port refuses
    with pytest.raises(NotImplementedError):
        tcli.run(["config=examples/parallel_learning/train.conf",
                  "num_trees=1", f"output_model={tmp_path}/m.txt",
                  "device=cpu", "verbose=-1"])

