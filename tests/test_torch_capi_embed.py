"""The port's C library (``liblgbm_tpu_torch.so``: an embedded CPython
forwarding the ``LGBM_*`` C ABI to ``lightgbm_tpu_torch.capi``;
``lightgbm_tpu_torch/native/capi.py build_capi``) on the CPU:

* (i) the library exports every function its header declares, and every
  name the embed forwards exists in ``lightgbm_tpu_torch.capi``;
* (ii) loaded into this interpreter with ``ctypes.PyDLL``, a sequence of
  C calls gives the model text byte for byte and the predictions bit for
  bit of the same calls through the port's Python ``capi``;
* (iii) the same C calls through the JAX package's ``liblgbm_tpu.so``
  (tests/conftest.py's ``native_lib``; each library through its own
  handle, ctypes' ``RTLD_LOCAL``) grow the same trees split for split,
  leaves within 1e-5 of the tree's largest (the xla plan's known f32
  divergence, ROADMAP.md queue 3; a 1e-3 gain floor keeps out splits of
  noise-level gain, which that divergence flips);
* (iv) the port's copies of the C, JNI and R host drivers
  (tests/torch_*_driver.c), compiled against the library with no Python
  on their stack, print their OK lines on ``cpu`` (those selected run
  side by side; the JNI and R stub hosts are marked slow, as their JAX
  counterparts are);
* (v) a booster loaded with no device raises the device rule's error
  through the C ABI where no card is visible.
"""
import ctypes
import os
import re
import subprocess

import numpy as np
import pytest

from lightgbm_tpu_torch import capi as tcapi
from lightgbm_tpu_torch.native import capi as ncapi
from lightgbm_tpu_torch.tree import Tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = ("objective=binary num_leaves=15 min_data_in_leaf=5 max_bin=31 "
          "learning_rate=0.3 verbose=-1")
ITERS = 4
STRUCTURE = ("split_feature", "threshold", "left_child", "right_child",
             "leaf_count", "internal_count", "decision_type")
#: host driver -> (sources beside it, compiler, extra flags, OK line)
DRIVERS = {
    "c": (["tests/torch_native_capi_driver.c"], "gcc",
          ["-I", ncapi.include_dir()], "NATIVE_CAPI_OK"),
    "jni": (["jni/lightgbm_jni.c", "tests/torch_jni_host_driver.c"], "gcc",
            [], "JNI-HOST OK"),
    "r": (["R-package/src/lightgbm_R.cpp", "R-package/src/rstub/rstub.c",
           "tests/torch_r_host_driver.c"], "g++",
          ["-std=c++17", "-I", "R-package/src/rstub"], "R-HOST OK"),
}

c_void_p, c_int, c_int64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _data(n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] - 0.6 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def _bind(lib):
    """Argument types of the C calls the tests make."""
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    lib.LGBM_DatasetCreateFromMat.argtypes = [
        c_void_p, c_int, ctypes.c_int32, ctypes.c_int32, c_int,
        ctypes.c_char_p, c_void_p, ctypes.POINTER(c_void_p)]
    lib.LGBM_DatasetSetField.argtypes = [c_void_p, ctypes.c_char_p,
                                         c_void_p, c_int, c_int]
    lib.LGBM_BoosterCreate.argtypes = [c_void_p, ctypes.c_char_p,
                                       ctypes.POINTER(c_void_p)]
    lib.LGBM_BoosterUpdateOneIter.argtypes = [c_void_p,
                                              ctypes.POINTER(c_int)]
    lib.LGBM_BoosterSaveModelToString.argtypes = [
        c_void_p, c_int, c_int64, ctypes.POINTER(c_int64), ctypes.c_char_p]
    lib.LGBM_BoosterLoadModelFromString.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(c_int), ctypes.POINTER(c_void_p)]
    lib.LGBM_BoosterPredictForMat.argtypes = [
        c_void_p, c_void_p, c_int, ctypes.c_int32, ctypes.c_int32, c_int,
        c_int, c_int, ctypes.c_char_p, ctypes.POINTER(c_int64), c_void_p]
    for name in ("LGBM_BoosterFree", "LGBM_DatasetFree"):
        getattr(lib, name).argtypes = [c_void_p]
    return lib


def _ok(lib, rc):
    assert rc == 0, lib.LGBM_GetLastError().decode()


def _c_train(lib, X, y, params):
    """DatasetCreateFromMat -> SetField(label) -> BoosterCreate -> ITERS
    x UpdateOneIter -> SaveModelToString -> PredictForMat on X, through
    the C ABI; returns (model text, predictions)."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float32)
    n, f = X.shape
    ds, bst = c_void_p(), c_void_p()
    _ok(lib, lib.LGBM_DatasetCreateFromMat(
        X.ctypes.data, 1, n, f, 1, params.encode(), None, ctypes.byref(ds)))
    _ok(lib, lib.LGBM_DatasetSetField(ds, b"label", y.ctypes.data, n, 0))
    _ok(lib, lib.LGBM_BoosterCreate(ds, params.encode(), ctypes.byref(bst)))
    fin = c_int()
    for _ in range(ITERS):
        _ok(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    size = c_int64()
    _ok(lib, lib.LGBM_BoosterSaveModelToString(bst, -1, 0,
                                               ctypes.byref(size), None))
    buf = ctypes.create_string_buffer(size.value)
    _ok(lib, lib.LGBM_BoosterSaveModelToString(bst, -1, size.value,
                                               ctypes.byref(size), buf))
    out = np.zeros(n, dtype=np.float64)
    got = c_int64()
    _ok(lib, lib.LGBM_BoosterPredictForMat(
        bst, X.ctypes.data, 1, n, f, 1, 0, -1, b"", ctypes.byref(got),
        out.ctypes.data))
    assert got.value == n
    _ok(lib, lib.LGBM_BoosterFree(bst))
    _ok(lib, lib.LGBM_DatasetFree(ds))
    return buf.value.decode(), out


@pytest.fixture(scope="module")
def lib_path():
    return ncapi.build_capi()


@pytest.fixture(scope="module")
def lib(lib_path):
    lib = _bind(ctypes.PyDLL(lib_path))
    assert lib.LTPU_EnsureInitialized() == 0
    return lib


@pytest.fixture(scope="module")
def drivers(lib_path, tmp_path_factory, request):
    """The host drivers whose tests were selected, built and started
    side by side on ``cpu``: by name, (process, its output's path)."""
    out = tmp_path_factory.mktemp("hosts")
    libdir = os.path.dirname(lib_path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    test = test_host_driver_prints_its_ok_line_on_cpu.__name__
    selected = {item.callspec.params["name"] for item in
                request.session.items if item.originalname == test}
    procs = {}
    try:
        for name, (srcs, cc, flags, _) in DRIVERS.items():
            if name not in selected:
                continue
            exe = str(out / name)
            build = subprocess.run(
                [cc, "-O1", *flags, *srcs, "-o", exe, "-L", libdir,
                 "-llgbm_tpu_torch", "-lm", f"-Wl,-rpath,{libdir}"],
                cwd=REPO, capture_output=True, text=True)
            assert build.returncode == 0, build.stderr
            log = str(out / f"{name}.log")
            arg = REPO if name == "c" else str(out / f"{name}_model.txt")
            with open(log, "w") as fh:
                procs[name] = (subprocess.Popen(
                    [exe, "cpu", arg], stdout=fh, stderr=subprocess.STDOUT,
                    env=env, cwd=REPO), log)
        yield procs
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def test_library_exports_the_header_and_forwards_to_capi(lib_path):
    """(i) ``nm -D`` lists every function the header declares; every
    ``LGBM_*`` name the embed forwards is a function of the port's
    capi; the library is the port's own, built under build/capi."""
    with open(os.path.join(ncapi.include_dir(),
                           "lightgbm_tpu_c_api.h")) as fh:
        declared = set(re.findall(r"^(?:int|const char\*) ((?:LGBM|LTPU)_\w+)\(",
                                  fh.read(), re.M))
    assert len(declared) >= 54
    nm = subprocess.run(["nm", "-D", "--defined-only", lib_path],
                        capture_output=True, text=True, check=True).stdout
    exported = set(re.findall(r" T (\w+)$", nm, re.M))
    assert declared <= exported, declared - exported
    with open(ncapi.SOURCE) as fh:
        src = fh.read()
    forwarded = set(re.findall(r'"(LGBM_\w+)"', src))
    assert len(forwarded) >= 50
    missing = {n for n in forwarded if not callable(getattr(tcapi, n, None))}
    assert not missing, missing
    assert 'PyImport_ImportModule("lightgbm_tpu_torch.capi")' in src
    assert lib_path.startswith(ncapi.BUILD_DIR)
    assert os.path.basename(lib_path) == "liblgbm_tpu_torch.so"
    # a second call finds the built library
    assert ncapi.build_capi() == lib_path


def test_c_calls_equal_the_python_capi(lib):
    """(ii) The model text byte for byte and the predictions bit for bit
    of the Python capi's same calls."""
    X, y = _data()
    params = PARAMS + " device=cpu"
    text, pred = _c_train(lib, X, y, params)
    out = [None]
    assert tcapi.LGBM_DatasetCreateFromMat(X, params, None, out) == 0
    ds = out[0]
    assert tcapi.LGBM_DatasetSetField(ds, "label", y) == 0
    assert tcapi.LGBM_BoosterCreate(ds, params, out) == 0
    bst = out[0]
    for _ in range(ITERS):
        assert tcapi.LGBM_BoosterUpdateOneIter(bst) == 0
    assert tcapi.LGBM_BoosterSaveModelToString(bst, -1, out) == 0
    assert text == out[0]
    assert tcapi.LGBM_BoosterPredictForMat(bst, X, 0, -1, out) == 0
    assert pred.tobytes() == np.asarray(out[0], np.float64).tobytes()
    assert text.count("Tree=") == ITERS


def test_c_calls_grow_the_jax_librarys_trees(lib, native_lib):
    """(iii) The same C calls through the JAX package's library: split
    for split, leaves within 1e-5 of the tree's largest."""
    X, y = _data()
    # a gain floor, as tests/test_torch_parallel.py's mesh comparison
    # has: a split of noise-level gain (7.6e-6 on these rows) flips
    # between the packages with the last bits of the f32 sums
    params = PARAMS + " min_gain_to_split=1e-3"
    text, _ = _c_train(lib, X, y, params + " device=cpu")
    jtext, _ = _c_train(_bind(ctypes.PyDLL(native_lib)), X, y, params)
    trees = [[Tree.from_string("num_leaves=" + b)
              for b in t.split("num_leaves=")[1:]] for t in (text, jtext)]
    assert len(trees[0]) == len(trees[1]) == ITERS
    for i, (tt, jt) in enumerate(zip(*trees)):
        for f in STRUCTURE:
            np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                          f"tree {i} {f}")
        scale = float(np.abs(jt.leaf_value).max())
        np.testing.assert_allclose(tt.leaf_value, jt.leaf_value, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f"tree {i}")


@pytest.mark.parametrize("name", [
    "c", pytest.param("jni", marks=pytest.mark.slow),
    pytest.param("r", marks=pytest.mark.slow)])
def test_host_driver_prints_its_ok_line_on_cpu(drivers, name):
    """(iv) The C host, and the JNI binding and the R shim compiled
    unchanged, over the port's library on ``cpu``.  The JNI and R stub
    hosts are slow, as their JAX counterparts are (each embeds another
    interpreter and trains; chip_smoke.py phase 19 (c) runs both on the
    card)."""
    proc, log = drivers[name]
    rc = proc.wait(timeout=300)
    with open(log) as fh:
        text = fh.read()
    assert rc == 0, text[-3000:]
    assert DRIVERS[name][3] in text, text[-3000:]


def test_loaded_booster_without_a_device_raises_the_device_rule(
        lib, monkeypatch):
    """(v) A model loaded through the C ABI takes the default device,
    the card: with none visible, its first prediction fails with the
    device rule's error; after ``LGBM_BoosterResetParameter(device=cpu)``
    it predicts."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(n=200)
    text, pred = _c_train(lib, X, y, PARAMS + " device=cpu")
    bst, iters = c_void_p(), c_int()
    _ok(lib, lib.LGBM_BoosterLoadModelFromString(
        text.encode(), ctypes.byref(iters), ctypes.byref(bst)))
    assert iters.value == ITERS
    Xc = np.ascontiguousarray(X)
    out = np.zeros(len(X))
    got = c_int64()

    def predict():
        return lib.LGBM_BoosterPredictForMat(
            bst, Xc.ctypes.data, 1, len(X), X.shape[1], 1, 0, -1, b"",
            ctypes.byref(got), out.ctypes.data)
    assert predict() == -1
    err = lib.LGBM_GetLastError().decode()
    assert err.startswith("RuntimeError: device='cuda'"), err
    assert "no CUDA device is available" in err
    lib.LGBM_BoosterResetParameter.argtypes = [c_void_p, ctypes.c_char_p]
    _ok(lib, lib.LGBM_BoosterResetParameter(bst, b"device=cpu"))
    _ok(lib, predict())
    assert out.tobytes() == pred.tobytes()
    _ok(lib, lib.LGBM_BoosterFree(bst))
