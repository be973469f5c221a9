"""The port's file entry point against the JAX package on the CPU: the
native parser and binner, ``data_loader.load_file`` and two-round
streaming, every construction route byte for byte (in RAM from a file,
streamed at two chunk sizes, ``push_rows`` dense and CSR, the
``from_sampled_columns`` flow, native binning on and off under 1 and 4
threads, under 8bit, 4bit and auto storage), the binary caches (the
port's round trip v1-v4, JAX-written v1-v4 caches, the raw bin section
byte for byte, the refusals, and a process that loads a JAX-written
cache and trains without importing jax), the lazy Dataset API and
``Booster.reset_training_data``."""
import glob
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from scipy import sparse as sp

import lightgbm_tpu as J
import lightgbm_tpu.native  # noqa: F401  (J.native)
import lightgbm_tpu_torch as T
from lightgbm_tpu import data_loader as jdl
from lightgbm_tpu import dataset_io as jio
from lightgbm_tpu.dataset import Dataset as JCore
from lightgbm_tpu_torch import data_loader as tdl
from lightgbm_tpu_torch import dataset_io as tio
from lightgbm_tpu_torch import native as tnative
from lightgbm_tpu_torch.dataset import Dataset as TCore
from lightgbm_tpu_torch.dataset import split_sample_columns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "*", "*.train"))
                  + glob.glob(os.path.join(REPO, "examples", "*", "*.test")))
#: the JAX side needs no compile cache for construction
JAX = {"compile_cache_dir": "", "verbose": -1}
PORT = {"device": "cpu", "verbose": -1}
#: each storage layout with a max_bin it takes
PACKINGS = {"8bit": {"max_bin": 63}, "4bit": {"max_bin": 15,
                                              "bin_packing": "4bit"},
            "auto": {"max_bin": 63, "bin_packing": "auto"}}


#: the JAX package's native parser, before jax_loadtxt takes it out
_JAX_LOAD_CSV = J.native.text_loader.load_csv


@pytest.fixture(autouse=True)
def jax_loadtxt(monkeypatch):
    """The JAX package's native parser sums a decimal's digits in
    floating point (off by an ulp or more on most values of
    examples/*, ROADMAP.md queue 3); with it raising, its ``load_file``
    parses through ``np.loadtxt``, whose doubles the port's correctly
    rounded parser gives."""
    def off(*a, **k):
        raise RuntimeError("native parse off")
    monkeypatch.setattr(J.native.text_loader, "load_csv", off)


def synthetic_rows(n=3000, seed=0):
    """label, 6 dense columns (NaNs, exact zeros), 4 sparse columns that
    rarely overlap (EFB bundles them), a 3-value column (a crumb under
    auto) and a categorical column of 12 values."""
    rng = np.random.RandomState(seed)
    dense = rng.randn(n, 6)
    dense[rng.rand(n, 6) < 0.05] = np.nan
    dense[:, 2] = np.where(rng.rand(n) < 0.3, 0.0, dense[:, 2])
    sparse_cols = np.zeros((n, 4))
    owner = rng.randint(0, 8, n)
    for j in range(4):
        rows = owner == j
        sparse_cols[rows, j] = rng.rand(rows.sum()) * 5 + 0.5
    three = rng.randint(0, 3, n).astype(float)
    cat = rng.randint(0, 12, n).astype(float)
    X = np.column_stack([dense, sparse_cols, three, cat])
    y = (np.nan_to_num(dense[:, 0]) + 0.2 * cat / 12
         + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


@pytest.fixture(scope="module")
def rows_file(tmp_path_factory):
    """synthetic_rows as a TSV, label first, in %.17g."""
    X, y = synthetic_rows()
    path = str(tmp_path_factory.mktemp("rows") / "rows.tsv")
    np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter="\t")
    return path, X, y


# ---------------------------------------------------------------------------
# the native library and the loader
# ---------------------------------------------------------------------------
def test_native_library_builds_under_build_native():
    assert tnative.loaded(), tnative.LOAD_ERROR
    path = tnative.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert not glob.glob(os.path.join(REPO, "lightgbm_tpu_torch", "native",
                                      "*.so"))


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_native_parse_equals_loadtxt(path):
    sep = "\t" if "\t" in open(path).readline() else ","
    got = tnative.text_loader.load_csv(path, sep, 0)
    want = np.loadtxt(path, delimiter=sep, ndmin=2)
    assert got.tobytes() == want.tobytes()


def test_native_parse_is_correctly_rounded(tmp_path):
    """%.17g round trips every double (NaN, +-inf, +-0, subnormals,
    1e300), and %g and short decimals parse as np.loadtxt does."""
    rng = np.random.RandomState(1)
    X = np.column_stack([rng.randn(4000, 4), rng.randn(4000) * 1e-310,
                         rng.randn(4000) * 1e300, np.round(rng.randn(4000), 3),
                         rng.randn(4000).astype(np.float32)])
    X[::7, 0] = np.nan
    X[::11, 1] = 0.0
    X[::13, 1] = -0.0
    X[3, 2], X[4, 2] = np.inf, -np.inf
    p17 = str(tmp_path / "x17.tsv")
    np.savetxt(p17, X, fmt="%.17g", delimiter="\t")
    assert tnative.text_loader.load_csv(p17, "\t", 0).tobytes() \
        == X.tobytes()
    pg = str(tmp_path / "xg.csv")
    np.savetxt(pg, X, fmt="%g", delimiter=",")
    assert tnative.text_loader.load_csv(pg, ",", 0).tobytes() \
        == np.loadtxt(pg, delimiter=",").tobytes()


def test_jax_native_parse_is_not_correctly_rounded():
    """Pins the divergence the jax_loadtxt fixture works around."""
    path = os.path.join(REPO, "examples", "regression", "regression.train")
    got = _JAX_LOAD_CSV(path, "\t", 0)
    assert not np.array_equal(got, np.loadtxt(path, delimiter="\t"))


def _same_load(jres, tres):
    jX, jy, jex = jres
    tX, ty, tex = tres
    if sp.issparse(jX):
        assert sp.issparse(tX)
        jX, tX = jX.toarray(), tX.toarray()
    assert jX.tobytes() == tX.tobytes()
    assert (jy is None) == (ty is None)
    if jy is not None:
        assert np.asarray(jy).tobytes() == np.asarray(ty).tobytes()
    assert sorted(jex) == sorted(tex)
    for k in jex:
        np.testing.assert_array_equal(np.asarray(jex[k]), np.asarray(tex[k]))


@pytest.mark.parametrize("path", EXAMPLES,
                         ids=[os.path.basename(p) for p in EXAMPLES])
def test_load_file_equals_jax(path):
    _same_load(jdl.load_file(path, J.Config.from_params(JAX)),
               tdl.load_file(path, T.Config.from_params(PORT)))


@pytest.mark.parametrize("spec", [
    {"has_header": True, "label_column": "name:target"},
    {"has_header": True, "label_column": "name:target",
     "weight_column": "name:w", "group_column": "name:qid",
     "ignore_column": "name:junk", "categorical_column": "name:c"},
    {"label_column": "1", "weight_column": "2", "group_column": "0",
     "ignore_column": "5"}], ids=["header", "names", "indices"])
def test_load_file_column_roles(tmp_path, spec):
    rng = np.random.RandomState(2)
    n = 300
    qid = np.repeat(np.arange(30)[::-1], 10)
    cols = {"qid": qid, "target": rng.randint(0, 3, n),
            "w": rng.rand(n) + 0.5, "a": rng.randn(n), "c": rng.randint(0, 5, n),
            "junk": rng.randn(n), "b": rng.randn(n)}
    names = list(cols)
    path = str(tmp_path / "roles.csv")
    header = ",".join(names) if spec.get("has_header") else ""
    np.savetxt(path, np.column_stack([cols[k] for k in names]), fmt="%.17g",
               delimiter=",", header=header, comments="")
    jres = jdl.load_file(path, J.Config.from_params(dict(JAX, **spec)))
    tres = tdl.load_file(path, T.Config.from_params(dict(PORT, **spec)))
    _same_load(jres, tres)
    if "group_column" in spec:
        np.testing.assert_array_equal(tres[2]["group"], np.full(30, 10))


def test_load_file_libsvm_and_side_files(tmp_path):
    rng = np.random.RandomState(3)
    path = str(tmp_path / "data.svm")
    with open(path, "w") as f:
        for i in range(200):
            feats = sorted(rng.choice(40, 5, replace=False))
            f.write(f"{i % 2} " + " ".join(
                f"{j}:{rng.randn():.6g}" for j in feats) + "\n")
    np.savetxt(path + ".weight", rng.rand(200) + 0.1)
    np.savetxt(path + ".query", np.full(20, 10), fmt="%d")
    np.savetxt(path + ".init", rng.randn(200))
    _same_load(jdl.load_file(path, J.Config.from_params(JAX)),
               tdl.load_file(path, T.Config.from_params(PORT)))


def test_qid_to_group_sizes():
    q = np.array([5, 5, 3, 3, 3, 9])
    np.testing.assert_array_equal(tdl.qid_to_group_sizes(q),
                                  jdl.qid_to_group_sizes(q))
    with pytest.raises(T.LightGBMError, match="not contiguous"):
        tdl.qid_to_group_sizes(np.array([1, 2, 1]))


# ---------------------------------------------------------------------------
# construction, byte for byte
# ---------------------------------------------------------------------------
def _params(packing, **kw):
    return dict(PACKINGS[packing], categorical_column="12",
                bin_construct_sample_cnt=5000, **kw)


def _construct(pkg, core_cls, route, path, X, y, packing):
    """The core dataset of one construction route in package ``pkg``."""
    side = JAX if pkg is J else PORT
    p = dict(side, **_params(packing))
    if route.startswith("two_round"):
        p.update(use_two_round_loading=True,
                 streaming_chunk_rows=int(route.split("_")[-1]))
        return pkg.Dataset(path, params=p).construct()
    if route.startswith("native"):
        _, on, threads = route.split("_")
        p.update(native_binning=on == "on", construct_threads=int(threads))
        return pkg.Dataset(path, params=p).construct()
    ref = pkg.Dataset(path, params=p).construct()
    if route == "in_ram":
        return ref
    if route == "sampled_columns":
        vals, rows = split_sample_columns(X)
        core = core_cls.from_sampled_columns(
            vals, rows, X.shape[0], X.shape[0],
            config=pkg.Config.from_params(p), categorical_features=[11])
    else:
        core = core_cls.from_reference_for_push(ref, X.shape[0])
    for s in range(0, X.shape[0], 700):
        chunk = X[s:s + 700]
        if route == "push_rows_csr":
            c = sp.csr_matrix(np.where(chunk == 0, 0, chunk))
            core.push_rows_csr(c.indptr, c.indices, c.data, s)
        else:
            core.push_rows(chunk, s)
    return core.finish_load()


ROUTES = ["in_ram", "two_round_700", "two_round_4096", "push_rows",
          "push_rows_csr", "sampled_columns", "native_on_1", "native_on_4",
          "native_off_1", "native_off_4"]


@pytest.mark.parametrize("packing", list(PACKINGS))
@pytest.mark.parametrize("route", ROUTES)
def test_construction_bytes_equal_jax(rows_file, route, packing):
    path, X, y = rows_file
    jc = _construct(J, JCore, route, path, X, y, packing)
    tc = _construct(T, TCore, route, path, X, y, packing)
    assert np.asarray(tc.group_bins).tobytes() \
        == np.asarray(jc.group_bins).tobytes()
    assert tc.feature_infos() == jc.feature_infos()
    assert [m.to_state() for m in tc.mappers] \
        == [m.to_state() for m in jc.mappers]
    assert tc._bundles == jc._bundles
    lay_j, lay_t = jc.bin_layout, tc.bin_layout
    assert (lay_j is None) == (lay_t is None)
    if lay_j is not None:
        assert lay_t.to_state() == lay_j.to_state()
    if route != "sampled_columns":
        # every route lands the in-RAM bytes (two-round samples all rows)
        ram = _construct(T, TCore, "in_ram", path, X, y, packing)
        assert np.asarray(tc.group_bins).tobytes() \
            == np.asarray(ram.group_bins).tobytes()


def test_construction_bundles_and_packs(rows_file):
    """The synthetic rows reach the native bundle and categorical paths
    and all three sections of the auto layout."""
    path, X, y = rows_file
    core = _construct(T, TCore, "in_ram", path, X, y, "auto")
    assert any(len(b) > 1 for b in core._bundles)
    assert any(f.is_categorical for f in core.features)
    assert core.bin_layout.crumb_groups > 0
    assert core.bin_layout.packed_groups > core.bin_layout.crumb_groups


def test_two_round_metadata_and_side_files(tmp_path):
    """Streaming takes the label, weight and query columns and the side
    files as the in-RAM load does, in both packages."""
    X, y = synthetic_rows(600, seed=4)
    w = np.random.RandomState(4).rand(600) + 0.5
    qid = np.repeat(np.arange(60), 10)
    path = str(tmp_path / "meta.tsv")
    np.savetxt(path, np.column_stack([y, w, qid, X]), fmt="%.17g",
               delimiter="\t")
    np.savetxt(path + ".init", np.arange(600) * 0.01)
    p = dict(weight_column="1", group_column="2", use_two_round_loading=True,
             streaming_chunk_rows=128, bin_construct_sample_cnt=5000)
    jc = J.Dataset(path, params=dict(JAX, **p)).construct()
    tc = T.Dataset(path, params=dict(PORT, **p)).construct()
    for f in ("label", "weight", "group", "init_score"):
        np.testing.assert_array_equal(tc.get_field(f), jc.get_field(f), f)
    assert np.asarray(tc.group_bins).tobytes() \
        == np.asarray(jc.group_bins).tobytes()


def test_init_side_file_applies_only_when_streaming(tmp_path):
    """<data>.init seeds the scores of a two-round load and is dropped by
    the in-RAM load, in the port as in the JAX package (ROADMAP.md
    queue 3)."""
    X, y = synthetic_rows(300, seed=5)
    path = str(tmp_path / "init.tsv")
    np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter="\t")
    np.savetxt(path + ".init", np.arange(300) * 0.5)
    for pkg, side in ((T, PORT), (J, JAX)):
        assert pkg.Dataset(path, params=side).construct() \
            .get_init_score() is None
        streamed = pkg.Dataset(path, params=dict(
            side, use_two_round_loading=True)).construct()
        np.testing.assert_array_equal(
            np.asarray(streamed.get_init_score()), np.arange(300) * 0.5)


def test_sharded_construction_is_refused(rows_file):
    path, _, _ = rows_file
    with pytest.raises(T.LightGBMError, match="sharded"):
        T.Dataset(path, params=dict(PORT, sharded_shards=2)).construct()


# ---------------------------------------------------------------------------
# binary caches
# ---------------------------------------------------------------------------
#: cache version -> (storage layout, binary_cache_v2)
VERSIONS = {1: ("8bit", False), 2: ("8bit", True), 3: ("4bit", True),
            4: ("auto", True)}


def _core(pkg, rows_file, version):
    path, _, _ = rows_file
    packing, v2 = VERSIONS[version]
    side = JAX if pkg is J else PORT
    p = dict(side, **_params(packing), binary_cache_v2=v2)
    return pkg.Dataset(path, params=p).construct()


def _sections(path):
    """(header blob, raw bin section, footer) of a v2-v4 cache."""
    raw = open(path, "rb").read()
    off = len(jio.BINARY_TOKEN) + len(jio.MAGIC_V2)
    (blen,) = struct.unpack("<Q", raw[off:off + 8])
    blob = raw[off + 8:off + 8 + blen]
    return blob, raw[off + 8 + blen:-jio._FOOTER_LEN], raw[-jio._FOOTER_LEN:]


def _same_core(a, b):
    assert np.asarray(a.group_bins).tobytes() \
        == np.asarray(b.group_bins).tobytes()
    assert a.feature_infos() == b.feature_infos()
    for f in ("num_data", "num_total_features", "used_features",
              "group_num_bin", "group_is_multi", "_bundles", "feature_names",
              "max_bin", "_categorical_features"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("label", "weight", "group", "init_score"):
        x, y = a.get_field(f), b.get_field(f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.asarray(x).tobytes() == np.asarray(y).tobytes(), f
    assert [m.to_state() for m in a.mappers] \
        == [m.to_state() for m in b.mappers]
    assert [(f.feature_idx, f.group, f.offset, f.collapsed_default)
            for f in a.features] == [(f.feature_idx, f.group, f.offset,
                                      f.collapsed_default) for f in b.features]
    la, lb = a.bin_layout, b.bin_layout
    assert (la is None) == (lb is None)
    if la is not None:
        assert la.to_state() == lb.to_state()


@pytest.mark.parametrize("version", list(VERSIONS))
def test_port_cache_round_trip(rows_file, tmp_path, version):
    core = _core(T, rows_file, version)
    path = str(tmp_path / "t.bin")
    tio.save_binary(core, path)
    assert tio.is_binary_file(path)
    back = tio.load_binary(path)
    _same_core(core, back)
    if version > 1:
        assert isinstance(back.group_bins, np.memmap)
        blob, _, _ = _sections(path)
        assert tio._loads(blob)["version"] == version


@pytest.mark.parametrize("version", list(VERSIONS))
def test_jax_written_cache_loads_in_the_port(rows_file, tmp_path, version):
    jc = _core(J, rows_file, version)
    path = str(tmp_path / "j.bin")
    jio.save_binary(jc, path)
    want = jio.load_binary(path)
    got = tio.load_binary(path)
    assert type(got.mappers[0]).__module__ == "lightgbm_tpu_torch.binning"
    if got.bin_layout is not None:
        assert type(got.bin_layout).__module__ == "lightgbm_tpu_torch.packing"
    _same_core(want, got)
    # and a lazy Dataset over the cache path sniffs it
    lazy = T.Dataset(path, params=dict(PORT, **_params(VERSIONS[version][0])))
    _same_core(want, lazy.construct())


@pytest.mark.parametrize("version", [2, 3, 4])
def test_cache_bin_section_equals_jax(rows_file, tmp_path, version):
    jp, tp = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    jio.save_binary(_core(J, rows_file, version), jp)
    tio.save_binary(_core(T, rows_file, version), tp)
    jblob, jbins, jfoot = _sections(jp)
    tblob, tbins, tfoot = _sections(tp)
    assert tbins == jbins
    assert tfoot[-4:] == jfoot[-4:]          # the bin section's digest
    # the headers hold the same fields; only the mappers' and layout's
    # class module differs in the pickle
    assert b"lightgbm_tpu.binning" in jblob
    assert b"lightgbm_tpu.binning" not in tblob
    jh, th = tio._loads(jblob), tio._loads(tblob)
    assert sorted(jh) == sorted(th)
    for k in jh:
        a, b = jh[k], th[k]
        if k == "mappers":
            assert [m.to_state() for m in a] == [m.to_state() for m in b]
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert (a is None) == (b is None), k
            if a is not None:
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), k
        else:
            assert a == b, k


def _refusal(pkg_io, path):
    with pytest.raises(Exception) as e:
        pkg_io.load_binary(path)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("damage", ["header", "truncated", "not_a_cache",
                                    "bin_byte", "torn_footer"])
def test_damaged_caches_are_refused_as_jax_refuses(rows_file, tmp_path,
                                                   damage):
    path = str(tmp_path / "d.bin")
    tio.save_binary(_core(T, rows_file, 2), path)
    raw = bytearray(open(path, "rb").read())
    off = len(jio.BINARY_TOKEN) + len(jio.MAGIC_V2) + 8
    if damage == "header":
        raw[off + 5:off + 25] = b"\x00" * 20
    elif damage == "truncated":
        raw = raw[:len(raw) - jio._FOOTER_LEN - 1000]
    elif damage == "not_a_cache":
        raw = bytearray(b"1,2,3\n4,5,6\n")
    elif damage == "bin_byte":
        raw[-jio._FOOTER_LEN - 10] ^= 0xFF
    else:
        raw = raw[:-3]
    open(path, "wb").write(bytes(raw))
    assert _refusal(tio, path) == _refusal(jio, path)
    assert tio.is_binary_file(path) == jio.is_binary_file(path)


def test_v1_cannot_hold_a_packed_matrix(rows_file, tmp_path):
    core = _core(T, rows_file, 3)
    with pytest.raises(T.LightGBMError, match="v1 binary format"):
        tio.save_binary(core, str(tmp_path / "p.bin"), version=1)


def test_packing_intent_is_checked_on_load(rows_file, tmp_path):
    path = str(tmp_path / "eight.bin")
    tio.save_binary(_core(T, rows_file, 2), path)
    with pytest.raises(T.LightGBMError, match="bin_packing=4bit"):
        T.Dataset(path, params=dict(PORT, bin_packing="4bit",
                                    max_bin=15)).construct()


def test_a_process_trains_from_a_jax_cache_without_jax(rows_file, tmp_path):
    path = str(tmp_path / "j.bin")
    jio.save_binary(_core(J, rows_file, 4), path)
    code = f"""
import sys
import lightgbm_tpu_torch as lgb
ds = lgb.Dataset({path!r}, params={{"device": "cpu", "verbose": -1,
                                   "bin_packing": "auto", "max_bin": 63}})
bst = lgb.train({{"objective": "binary", "device": "cpu", "verbose": -1,
                 "num_leaves": 7, "bin_packing": "auto", "max_bin": 63}},
                ds, 2)
assert bst.num_trees() == 2
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m.startswith("lightgbm_tpu.")]
assert not bad, bad
print("trained", bst.num_trees())
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"    # beside the suite's own workers
    # (-W error: the read-only memmap goes to the device without
    # torch's non-writable-array warning)
    r = subprocess.run([sys.executable, "-W", "error::UserWarning", "-c",
                        code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "trained 2" in r.stdout


# ---------------------------------------------------------------------------
# the lazy Dataset API and reset_training_data
# ---------------------------------------------------------------------------
def _message(fn):
    try:
        fn()
    except Exception as e:       # noqa: BLE001 - the message is compared
        return str(e)
    return None


def test_lazy_dataset_api_equals_jax(rows_file, tmp_path):
    path, X, y = rows_file
    rng = np.random.RandomState(6)
    w = rng.rand(len(y)) + 0.5
    out = {}
    for pkg, side in ((J, JAX), (T, PORT)):
        d = pkg.Dataset(X, label=y, params=dict(side, max_bin=63),
                        free_raw_data=False)
        r = {"nd": d.num_data(), "nf": d.num_feature()}
        d.set_weight(w).set_init_score(np.zeros(len(y)))
        r["before"] = [d.get_field(f) for f in ("label", "weight")]
        d.set_group([len(y) // 2, len(y) - len(y) // 2])
        core = d.construct()
        r["after"] = [d.get_field(f) for f in ("label", "weight", "group",
                                               "init_score")]
        d.set_label(1 - y)
        r["relabel"] = d.get_label()
        r["msg_ref"] = _message(lambda: d.set_reference(pkg.Dataset(X)))
        r["msg_field"] = _message(lambda: d.set_field("nope", y))
        v = d.create_valid(X[:500], label=y[:500])
        r["valid"] = np.asarray(v.construct().group_bins).tobytes()
        r["chain"] = len(v.get_ref_chain())
        sub = d.subset(np.arange(0, len(y), 3))
        r["sub"] = (sub.num_data(),
                    np.asarray(sub.construct().group_bins).tobytes())
        d.save_binary(str(tmp_path / f"{pkg.__name__}.bin"))
        r["saved"] = np.asarray(
            pkg.Dataset(str(tmp_path / f"{pkg.__name__}.bin"),
                        params=side).construct().group_bins).tobytes()
        r["bins"] = np.asarray(core.group_bins).tobytes()
        r["msg_file_nd"] = _message(lambda: pkg.Dataset(path).num_data())
        out[pkg] = r
    j, t = out[J], out[T]
    assert sorted(j) == sorted(t)
    for k in j:
        if isinstance(j[k], list):
            for a, b in zip(j[k], t[k]):
                np.testing.assert_array_equal(a, b, k)
        elif isinstance(j[k], np.ndarray):
            np.testing.assert_array_equal(j[k], t[k], k)
        else:
            assert j[k] == t[k], k


def test_reset_training_data_equals_jax():
    X, y = synthetic_rows(800, seed=7)
    X2, y2 = synthetic_rows(600, seed=8)
    p = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
         "min_data_in_leaf": 5}
    res = {}
    for pkg, side in ((J, JAX), (T, PORT)):
        bst = pkg.train(dict(p, **side), pkg.Dataset(X, label=y), 3,
                        keep_training_booster=True)
        before = bst.predict(X2[:50], raw_score=True)
        # (the JAX package takes a constructed core)
        bst.reset_training_data(pkg.Dataset(
            X2, label=y2, free_raw_data=False,
            params=dict(p, **side)).construct())
        kept = bst.predict(X2[:50], raw_score=True)
        it = bst.current_iteration
        bst.update()
        bst.num_trees()           # the JAX package flushes its trees here
        res[pkg] = (before, kept, it, bst.current_iteration, bst.models)
    (jb, jk, ji, ji2, jm), (tb, tk, ti, ti2, tm) = res[J], res[T]
    np.testing.assert_allclose(tk, tb, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tk, jk, rtol=1e-5, atol=1e-5)
    assert (ti, ti2) == (ji, ji2) == (3, 4)
    assert len(tm) == len(jm) == 4
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(a.split_feature, b.split_feature)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-5 * np.abs(a.leaf_value).max())
    bad = T.Dataset(X2[:, :5], label=y2, params=PORT, free_raw_data=False)
    bst = T.train(dict(p, **PORT), T.Dataset(X, label=y), 1,
                  keep_training_booster=True)
    with pytest.raises(T.LightGBMError, match="feature count mismatch"):
        bst.reset_training_data(bad)
