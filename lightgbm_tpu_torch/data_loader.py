"""Text data loading: CSV / TSV / LibSVM with column-role resolution
(port of lightgbm_tpu/data_loader.py).

Re-design of the reference's Parser + DatasetLoader text pipeline
(reference: src/io/parser.cpp:67-162 format auto-detection,
src/io/dataset_loader.cpp:23-158 header/column-role resolution,
src/io/metadata.cpp:23-26 side files <data>.weight / <data>.query).
CSV/TSV parse through the native loader (``native/``, correctly rounded:
the same doubles as ``np.loadtxt``), or ``np.loadtxt`` when the library
is not loaded; libsvm files parse to CSR.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import Config
from .dataset import split_sample_columns
from .utils.log import Log


def detect_format(sample_lines: List[str]) -> str:
    """Auto-detect csv/tsv/libsvm (reference parser.cpp:67-162): count
    parseable columns under each dialect on sample lines and pick the
    consistent one; ':' inside tokens marks libsvm."""
    def is_libsvm(line):
        toks = line.split()
        if not toks:
            return False
        rest = toks[1:] if ":" not in toks[0] else toks
        return len(rest) > 0 and all(":" in t for t in rest)

    votes = {"csv": 0, "tsv": 0, "libsvm": 0}
    for line in sample_lines:
        line = line.strip()
        if not line:
            continue
        if is_libsvm(line):
            votes["libsvm"] += 1
        elif "\t" in line:
            votes["tsv"] += 1
        elif "," in line:
            votes["csv"] += 1
    fmt = max(votes, key=votes.get)
    if votes[fmt] == 0:
        Log.fatal("Cannot detect data format (csv/tsv/libsvm)")
    return fmt


def _sniff_text_file(path: str, config: Config):
    """Shared format/header sniffing for both loaders: returns
    (fmt, sep, names) from the file's first lines."""
    with open(path) as f:
        first_lines = [f.readline() for _ in range(20)]
    has_header = config.has_header
    header_line = first_lines[0] if has_header else None
    data_sample = first_lines[1:] if has_header else first_lines
    fmt = detect_format([ln for ln in data_sample if ln])
    sep = "\t" if fmt == "tsv" else ","
    names = None
    if header_line is not None:
        names = [c.strip() for c in header_line.strip().split(sep)]
    return fmt, sep, names


def qid_to_group_sizes(qid: np.ndarray) -> np.ndarray:
    """Per-row query ids -> per-query sizes in APPEARANCE order (rows
    of one query must be contiguous, the reference contract;
    np.unique's sorted order would misassign boundaries for descending
    qids)."""
    qid = np.asarray(qid)
    if len(qid) == 0:
        return np.zeros(0, dtype=np.int64)
    change = np.flatnonzero(qid[1:] != qid[:-1])
    bounds = np.concatenate([[0], change + 1, [len(qid)]])
    sizes = np.diff(bounds)
    starts = qid[bounds[:-1]]
    if len(np.unique(starts)) != len(starts):
        Log.fatal("query/group column is not contiguous: the same qid "
                  "appears in non-adjacent row blocks")
    return sizes


def _resolve_file_columns(config: Config, names: Optional[List[str]],
                          ncol: int):
    """Shared label/weight/group/ignore/categorical column-role
    resolution (reference dataset_loader.cpp:23-158).  Returns
    categorical indices REMAPPED into the post-drop feature space so
    they line up with the returned matrix's columns."""
    label_col = _resolve_single(config.label_column, names, default=0)
    weight_cols = _parse_column_spec(config.weight_column, names)
    group_cols = _parse_column_spec(config.group_column, names)
    ignore_cols = set(_parse_column_spec(config.ignore_column, names))
    used = [i for i in range(ncol)
            if i != label_col and i not in weight_cols
            and i not in group_cols and i not in ignore_cols]
    raw_cat = set(_parse_column_spec(config.categorical_column, names))
    cat_feats = [f for f, i in enumerate(used) if i in raw_cat]
    return label_col, weight_cols, group_cols, used, cat_feats


def _load_side_files(path: str, extras: Dict) -> Dict:
    """Side files <data>.weight / .query / .init
    (reference metadata.cpp:23-26); existing keys win."""
    wf = path + ".weight"
    if os.path.exists(wf) and extras.get("weight") is None:
        extras["weight"] = np.loadtxt(wf, dtype=np.float32).reshape(-1)
    qf = path + ".query"
    if os.path.exists(qf) and extras.get("group") is None:
        extras["group"] = np.loadtxt(qf, dtype=np.int64).reshape(-1)
    inf = path + ".init"
    if os.path.exists(inf):
        extras["init_score"] = np.loadtxt(inf,
                                          dtype=np.float64).reshape(-1)
    return extras


def _parse_column_spec(spec: str, names: Optional[List[str]]) -> List[int]:
    """Resolve 'name:' or index column specs (reference
    dataset_loader.cpp:23-158)."""
    if not spec:
        return []
    out = []
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if tok.startswith("name:"):
            nm = tok[5:]
            if names and nm in names:
                out.append(names.index(nm))
            else:
                Log.warning(f"Column name {nm} not found in header")
        else:
            out.append(int(tok))
    return out


def _parse_text(path: str, sep: str, skip_rows: int) -> np.ndarray:
    """A csv/tsv file of numbers as a float64 matrix: the native parser
    when the library is loaded, else ``np.loadtxt`` (the same doubles;
    ``native.get_lib`` has logged why the library is missing)."""
    from . import native
    if native.get_lib() is not None:
        return native.text_loader.load_csv(path, sep, skip_rows)
    return np.loadtxt(path, delimiter=sep, skiprows=skip_rows, ndmin=2,
                      dtype=np.float64)


def load_file(path: str, config: Config
              ) -> Tuple[np.ndarray, Optional[np.ndarray], Dict]:
    """Load a training/prediction text file.

    Returns (feature_matrix, label, extras) where extras may hold
    weight / group arrays from columns or side files.
    """
    # native fast path for csv/tsv when the C++ loader is built
    has_header = config.has_header
    fmt, sep, names = _sniff_text_file(path, config)

    if fmt in ("csv", "tsv"):
        raw = _parse_text(path, sep, 1 if has_header else 0)
        label_col, weight_cols, group_cols, used, cat_feats = \
            _resolve_file_columns(config, names, raw.shape[1])
        X = raw[:, used]
        label = raw[:, label_col] if label_col is not None else None
        extras: Dict = {}
        if cat_feats:
            extras["categorical_feature"] = cat_feats
        if weight_cols:
            extras["weight"] = raw[:, weight_cols[0]].astype(np.float32)
        if group_cols:
            # group column holds per-row query ids -> convert to sizes
            qid = raw[:, group_cols[0]].astype(np.int64)
            extras["group"] = qid_to_group_sizes(qid)
    else:
        X, label = _load_libsvm(path)
        extras = {}

    return X, label, _load_side_files(path, extras)


def load_file_streaming(path: str, config: Config):
    """Two-round streaming construction: the float matrix never exists
    (reference two_round_loading, src/io/dataset_loader.cpp:180-265).

    Round 1 reservoir-samples up to ``bin_construct_sample_cnt`` parsed
    rows while counting lines; bin mappers and EFB bundles are fitted
    from the samples.  Round 2 re-reads the file in chunks, pushing
    binned rows straight into the packed (N, G) uint8 matrix — parse
    and bin OVERLAPPED: a producer thread parses ahead while the main
    thread bins, a bounded two-chunk queue in between (the native
    binner and numpy both release the GIL, so the stages genuinely run
    concurrently).  Peak host memory = samples + at most FOUR parsed
    chunks (two queued, one in the producer's hand, one being binned)
    + the uint8 matrix.

    Returns a constructed CoreDataset (metadata from label/weight/group
    columns and side files already applied).
    """
    import queue
    import threading

    from .dataset import Dataset as CoreDataset

    has_header = config.has_header
    fmt, sep, names = _sniff_text_file(path, config)
    if fmt == "libsvm":
        # libsvm files are sparse — route through the sparse in-RAM
        # path (bounded by nnz) rather than two-round
        X, label, extras = load_file(path, config)
        ds = CoreDataset.from_matrix(X, label=label,
                                     weight=extras.get("weight"),
                                     group=extras.get("group"),
                                     init_score=extras.get("init_score"),
                                     config=config)
        return ds

    def parse_lines(lines):
        return np.loadtxt(lines, delimiter=sep, ndmin=2, dtype=np.float64)

    # ---- round 1: count + reservoir sample ----
    sample_cnt = config.bin_construct_sample_cnt
    rng = np.random.RandomState(config.data_random_seed)
    reservoir: List[str] = []
    n_rows = 0
    with open(path) as f:
        if has_header:
            f.readline()
        for line in f:
            if not line.strip():
                continue
            if n_rows < sample_cnt:
                reservoir.append(line)
            else:
                j = rng.randint(0, n_rows + 1)
                if j < sample_cnt:
                    reservoir[j] = line
            n_rows += 1
    sample_raw = parse_lines(reservoir)
    label_col, weight_cols, group_cols, used, cat_feats = \
        _resolve_file_columns(config, names, sample_raw.shape[1])
    sample_X = sample_raw[:, used]
    sample_vals, sample_rows = split_sample_columns(sample_X)

    ds = CoreDataset.from_sampled_columns(
        sample_vals, sample_rows, sample_X.shape[0], n_rows,
        config=config,
        feature_names=[names[i] for i in used] if names else None,
        categorical_features=cat_feats or None)

    # ---- round 2: stream chunks into the bin matrix, parse || bin ----
    # A bounded two-chunk queue: the producer thread reads + parses
    # ahead while the consumer bins the current chunk.  Chunk
    # boundaries and parse order are identical to the old serial loop,
    # so the packed matrix is byte-identical.  Worst-case resident
    # parsed chunks: two queued + one in the producer's hand + one
    # being binned (see streaming_chunk_rows in Parameters.md).  The
    # `stop` event keeps a consumer-side failure from stranding the
    # producer in a blocking put() forever (thread + chunk leak).
    chunk_rows = max(1, int(config.streaming_chunk_rows))
    label = np.zeros(n_rows, dtype=np.float64)
    weight = np.zeros(n_rows, dtype=np.float32) if weight_cols else None
    qid = np.zeros(n_rows, dtype=np.int64) if group_cols else None
    chunk_q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer has aborted."""
        while not stop.is_set():
            try:
                chunk_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            with open(path) as f:
                if has_header:
                    f.readline()
                buf: List[str] = []
                for line in f:
                    if not line.strip():
                        continue
                    buf.append(line)
                    if len(buf) >= chunk_rows:
                        if not _put(("chunk", parse_lines(buf))):
                            return
                        buf = []
                if buf and not _put(("chunk", parse_lines(buf))):
                    return
            _put(("done", None))
        except BaseException as e:  # re-raised on the consumer side
            _put(("error", e))

    producer = threading.Thread(target=_produce, name="ltt-parse",
                                daemon=True)
    producer.start()
    row = 0
    try:
        while True:
            kind, payload = chunk_q.get()
            if kind == "done":
                break
            if kind == "error":
                raise payload
            row = _push_text_chunk(ds, payload, used, label_col,
                                   weight_cols, group_cols, label,
                                   weight, qid, row)
    finally:
        stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                chunk_q.get_nowait()
            except queue.Empty:
                break
        producer.join()
    ds.finish_load()
    ds.metadata.set_label(label)
    extras = _load_side_files(path, {
        "weight": weight,
        "group": qid_to_group_sizes(qid) if qid is not None else None,
    })
    if extras.get("weight") is not None:
        ds.metadata.set_weight(extras["weight"])
    if extras.get("group") is not None:
        ds.metadata.set_group(extras["group"])
    if extras.get("init_score") is not None:
        ds.metadata.set_init_score(extras["init_score"])
    return ds


def _push_text_chunk(ds, raw, used, label_col, weight_cols, group_cols,
                     label, weight, qid, row):
    n = raw.shape[0]
    ds.push_rows(raw[:, used], row)
    if label_col is not None:
        label[row:row + n] = raw[:, label_col]
    if weight_cols:
        weight[row:row + n] = raw[:, weight_cols[0]]
    if group_cols:
        qid[row:row + n] = raw[:, group_cols[0]].astype(np.int64)
    return row + n


def _resolve_single(spec: str, names: Optional[List[str]],
                    default: Optional[int]) -> Optional[int]:
    cols = _parse_column_spec(spec, names)
    if cols:
        return cols[0]
    return default


def _load_libsvm(path: str):
    """Parse a libsvm file to CSR (reference src/io/parser.hpp:87-126
    LibSVMParser).  Memory is bounded by nnz — the dense (N, max_feat)
    matrix is never materialized, so a wide 99%-sparse file (news20:
    15k x 1.3M) parses in ~nnz floats instead of OOMing; downstream
    Dataset construction walks the CSC columns (dataset.py
    _bin_data_sparse) without densifying either."""
    from array import array

    from scipy import sparse as sp

    labels = array("d")
    indptr = array("q", [0])
    indices = array("q")
    values = array("d")
    max_feat = -1
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            start = 0
            if ":" not in toks[0]:
                labels.append(float(toks[0]))
                start = 1
            else:
                labels.append(0.0)
            for t in toks[start:]:
                k, v = t.split(":", 1)
                idx = int(k)
                indices.append(idx)
                values.append(float(v))
                if idx > max_feat:
                    max_feat = idx
            indptr.append(len(indices))
    X = sp.csr_matrix(
        (np.frombuffer(values, dtype=np.float64),
         np.frombuffer(indices, dtype=np.int64),
         np.frombuffer(indptr, dtype=np.int64)),
        shape=(len(labels), max_feat + 1))
    return X, np.frombuffer(labels, dtype=np.float64)
