"""Binned-dataset binary cache (port of lightgbm_tpu/dataset_io.py;
the same file format, so either package reads the other's caches).

The analog of the reference's save_binary / LoadFromBinFile
(reference: dataset.cpp:18 token + :528-607 writer,
dataset_loader.cpp:171,266-486 auto-detected fast load): persists the
fully-binned matrix, mappers and metadata so repeat training skips
parsing + bin finding — the direct ancestor of a TPU HBM-resident
packed-bin snapshot.

Format v2 (round 11, default): after the shared token, an 8-byte
magic + a pickled header (schema version, mappers, metadata, the
``group_bins`` shape) + the RAW packed bin matrix bytes.  ``load_binary``
``np.memmap``s that raw section read-only, so a reload is near
zero-copy — the OS pages bins in on first device upload and the
process RSS stays bounded by what training actually touches, instead
of a full unpickled duplicate of the matrix.  v1 files (one pickle
holding everything, written by ``binary_cache_v2=false`` or older
versions) still load, with a deprecation warning.

The header pickles the bin mappers (``binning.BinMapper``) and the
packed layout's state.  A cache written by the JAX package names
``lightgbm_tpu.binning``; :class:`_PortUnpickler` maps every
``lightgbm_tpu.<module>`` class to the port's module of the same name
(the classes share their ``__slots__``), so loading one never imports
the JAX package.  The port pickles its own classes: its header differs
from the JAX package's by the module path alone, its bin section and
that section's digest not at all.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import zlib
from typing import Optional

import numpy as np

from .dataset import Dataset
from .utils.log import Log

BINARY_TOKEN = b"______LightGBM_TPU_Binary_File_Token______\n"
MAGIC_V2 = b"LTPUBC2\n"
FORMAT_VERSION = 2
# v3 = v2 container + a ``bin_packing`` header field describing the
# nibble-packed storage layout (packing.py).  The version only bumps
# for datasets that ARE packed: 8-bit datasets keep writing plain v2
# (loadable by every prior build), while a packed cache read by an
# older build refuses on the unknown version instead of silently
# mis-binning packed bytes as group columns.
FORMAT_VERSION_PACKED = 3
# v4 = v3 + a ``crumb_groups`` field in the ``bin_packing`` layout
# state (the 2-bit crumb section, packing.py three-section layout).
# Same refusal shape one tier up: nibble-only packed caches keep
# writing v3 (loadable by every r18+ build), while a crumb-carrying
# cache read by a pre-crumb build refuses on the unknown version
# instead of silently mis-widening crumb bytes as nibble pairs.
FORMAT_VERSION_CRUMB = 4
# hard sanity bound on the v2 header blob (mappers + metadata for even
# a 10k-feature dataset pickle to a few MB; a length field past this is
# a corrupted or hostile file, not a real header)
_MAX_HEADER_BYTES = 1 << 31
# r20 trailing integrity footer: magic + crc32(header blob) +
# crc32(bin section).  The raw bin section is otherwise UNPROTECTED —
# a torn write or flipped page there would train silently wrong.  The
# footer trails the bins so the memmap offset of every existing v2/v3/
# v4 file is unchanged; pre-footer files load with a warning.
FOOTER_MAGIC = b"LTPUFTR1"
_FOOTER = struct.Struct("<II")
_FOOTER_LEN = len(FOOTER_MAGIC) + _FOOTER.size
_CRC_FOLD_MIN = 4096


def _section_crc(buf) -> int:
    """Digest of one cache section, tiered exactly like the wire-frame
    digest (parallel/transport.py): plain crc32 below the fold
    threshold, crc32 of the 64-bit XOR word-fold above it — the fold
    is memory-bandwidth-bound, so verifying a multi-GB bin matrix
    costs a streaming read, not a software-crc32 crawl."""
    mv = memoryview(buf).cast("B")
    n = len(mv)
    if n < _CRC_FOLD_MIN:
        return zlib.crc32(mv) & 0xFFFFFFFF
    nw = n & ~7
    words = np.frombuffer(mv[:nw], dtype="<u8")
    fold = int(np.bitwise_xor.reduce(words))
    crc = zlib.crc32(fold.to_bytes(8, "little"))
    return zlib.crc32(mv[nw:], crc) & 0xFFFFFFFF


def _verify_footer(f, filename: str, header_blob: bytes, gb) -> None:
    """Read + verify the trailing footer; ``f`` must be positioned at
    the first byte after the bin section.  Anything
    between "no trailing bytes at all" (a legacy pre-footer cache,
    loads with a warning) and "a well-formed footer whose digests
    match" is rejected loudly — a half-written footer IS a torn
    write."""
    tail = f.read()
    if not tail:
        Log.warning(
            f"{filename}: no integrity footer (pre-footer cache) — "
            "loading unverified; re-save to add section digests")
        return
    if (len(tail) != _FOOTER_LEN
            or tail[:len(FOOTER_MAGIC)] != FOOTER_MAGIC):
        Log.fatal(
            f"{filename}: corrupted v2 trailer ({len(tail)} trailing "
            "bytes after the bin section do not form an integrity "
            "footer — torn write?)")
    want_h, want_b = _FOOTER.unpack(tail[len(FOOTER_MAGIC):])
    got_h = _section_crc(header_blob)
    if got_h != want_h:
        Log.fatal(
            f"{filename}: v2 header digest mismatch (recorded "
            f"{want_h:#010x}, computed {got_h:#010x}) — the cache is "
            "corrupt; delete and rebuild it")
    got_b = _section_crc(gb) if gb is not None else 0
    if got_b != want_b:
        Log.fatal(
            f"{filename}: v2 bin-section digest mismatch (recorded "
            f"{want_b:#010x}, computed {got_b:#010x}) — the cache is "
            "corrupt; delete and rebuild it")

# Virtual file schemes (the reference's VirtualFileReader/Writer +
# HDFSFile seam, src/io/file_io.cpp:54-165).  HDFS itself is a
# PERMANENT descope — no Hadoop client exists in the target
# environments — but the dispatch seam is kept: register an opener for
# a scheme ("hdfs", "s3", "gs", ...) and every binary-cache read/write
# routes through it.  fsspec plugs in as
# ``register_file_scheme("s3", fsspec.open)``.
_SCHEME_OPENERS = {}


def register_file_scheme(scheme: str, opener) -> None:
    """``opener(path, mode)`` must return a binary file-like object."""
    _SCHEME_OPENERS[scheme.lower()] = opener


def _open(filename: str, mode: str):
    if "://" in filename:
        scheme = filename.split("://", 1)[0].lower()
        op = _SCHEME_OPENERS.get(scheme)
        if op is None:
            Log.fatal(
                f"no opener registered for scheme '{scheme}://' — "
                "register one with lightgbm_tpu_torch.dataset_io."
                "register_file_scheme (HDFS is intentionally out of "
                "scope; any fsspec-style opener plugs in here)")
        return op(filename, mode)
    return open(filename, mode)


class _PortUnpickler(pickle.Unpickler):
    """Reads the JAX package's classes as the port's: a class of
    ``lightgbm_tpu.<module>`` is looked up in
    ``lightgbm_tpu_torch.<module>``."""

    def find_class(self, module, name):
        if module == "lightgbm_tpu" or module.startswith("lightgbm_tpu."):
            module = "lightgbm_tpu_torch" + module[len("lightgbm_tpu"):]
        return super().find_class(module, name)


def _loads(blob: bytes):
    return _PortUnpickler(io.BytesIO(blob)).load()


def _payload(dataset: Dataset, with_bins: bool) -> dict:
    """The pickled state shared by both format versions; v2 keeps the
    bin matrix OUT of the pickle (raw section instead)."""
    out = {
        "num_data": dataset.num_data,
        "num_total_features": dataset.num_total_features,
        "mappers": dataset.mappers,
        "used_features": dataset.used_features,
        "group_num_bin": dataset.group_num_bin,
        "group_is_multi": dataset.group_is_multi,
        "bundles": dataset._bundles,
        "feature_names": dataset.feature_names,
        "max_bin": dataset.max_bin,
        "label": dataset.metadata.label,
        "weight": dataset.metadata.weight,
        "query_boundaries": dataset.metadata.query_boundaries,
        "init_score": dataset.metadata.init_score,
        "monotone": dataset.monotone_constraints,
        "categorical_features": dataset._categorical_features,
    }
    if with_bins:
        out["group_bins"] = dataset.group_bins
    return out


def save_binary(dataset: Dataset, filename: str,
                version: Optional[int] = None) -> None:
    """Persist a constructed dataset.  ``version`` defaults to the
    dataset config's ``binary_cache_v2`` knob (v2 unless disabled)."""
    if version is None:
        version = 2 if getattr(dataset.config, "binary_cache_v2", True) \
            else 1
    if version == 1:
        if getattr(dataset, "bin_layout", None) is not None:
            # the v1 pickle has no layout field: a packed matrix would
            # reload as plain 8-bit group columns and silently mis-bin
            Log.fatal(
                f"{filename}: the v1 binary format cannot represent a "
                "nibble-packed bin matrix "
                f"({dataset.bin_layout!r}) — save with "
                "binary_cache_v2=true (the default) or construct with "
                "bin_packing=8bit")
        payload = dict(_payload(dataset, with_bins=True), version=1)
        with _open(filename, "wb") as f:
            f.write(BINARY_TOKEN)
            pickle.dump(payload, f, protocol=4)
        Log.info(f"Saved binned dataset to binary file {filename} (v1)")
        return
    lay = getattr(dataset, "bin_layout", None)
    header = dict(_payload(dataset, with_bins=False),
                  version=(FORMAT_VERSION if lay is None
                           else (FORMAT_VERSION_CRUMB
                                 if lay.crumb_groups
                                 else FORMAT_VERSION_PACKED)))
    if lay is not None:
        header["bin_packing"] = lay.to_state()
    gb = dataset.group_bins
    if gb is not None:
        gb = np.ascontiguousarray(gb, dtype=np.uint8)
        header["bins_shape"] = [int(s) for s in gb.shape]
    else:
        header["bins_shape"] = None
    blob = pickle.dumps(header, protocol=4)
    with _open(filename, "wb") as f:
        f.write(BINARY_TOKEN)
        f.write(MAGIC_V2)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        if gb is not None:
            # raw bytes, no pickle framing: this section is what
            # load_binary memmaps in place
            f.write(memoryview(gb).cast("B"))
        f.write(FOOTER_MAGIC)
        f.write(_FOOTER.pack(_section_crc(blob),
                             _section_crc(gb) if gb is not None else 0))
    Log.info(f"Saved binned dataset to binary file {filename} "
             f"(v{header['version']})")


def is_binary_file(filename: str) -> bool:
    try:
        with _open(filename, "rb") as f:
            return f.read(len(BINARY_TOKEN)) == BINARY_TOKEN
    except Exception:
        # a probe, not an assertion: unreadable paths, unregistered
        # schemes, and opener-specific errors all mean "not a binary
        # dataset file" here
        return False


def _read_v2(f, filename: str):
    """Header + (memmapped when possible) bin matrix of a v2 file whose
    token+magic were already consumed.  Corrupted headers and truncated
    bin sections are rejected loudly — a half-written cache must never
    train silently wrong."""
    raw = f.read(8)
    if len(raw) < 8:
        Log.fatal(f"{filename}: truncated v2 binary dataset header")
    (blob_len,) = struct.unpack("<Q", raw)
    if blob_len > _MAX_HEADER_BYTES:
        Log.fatal(f"{filename}: corrupted v2 header (implausible "
                  f"header length {blob_len})")
    blob = f.read(blob_len)
    if len(blob) != blob_len:
        Log.fatal(f"{filename}: truncated v2 binary dataset header")
    try:
        payload = _loads(blob)
    except Exception as e:
        Log.fatal(f"{filename}: corrupted v2 binary dataset header "
                  f"({type(e).__name__}: {e})")
    if payload.get("version") not in (FORMAT_VERSION,
                                      FORMAT_VERSION_PACKED,
                                      FORMAT_VERSION_CRUMB):
        Log.fatal(f"{filename}: unsupported binary dataset version "
                  f"{payload.get('version')!r}")
    shape = payload.get("bins_shape")
    offset = len(BINARY_TOKEN) + len(MAGIC_V2) + 8 + blob_len
    if shape is None:
        _verify_footer(f, filename, blob, None)
        return payload, None
    shape = tuple(int(s) for s in shape)
    need = int(np.prod(shape, dtype=np.int64))
    if "://" not in filename and os.path.isfile(filename):
        if os.path.getsize(filename) - offset < need:
            Log.fatal(f"{filename}: truncated v2 bin section (need "
                      f"{need} bytes)")
        # the zero-copy path: the packed matrix stays a read-only
        # page-cache mapping; RSS grows only with pages actually read
        # (the footer digest below streams it once through the page
        # cache — evictable, never an unpickled in-RSS duplicate)
        gb = np.memmap(filename, dtype=np.uint8, mode="r",
                       offset=offset, shape=shape)
        f.seek(offset + need)
    else:
        buf = f.read(need)
        if len(buf) != need:
            Log.fatal(f"{filename}: truncated v2 bin section (need "
                      f"{need} bytes)")
        gb = np.frombuffer(buf, dtype=np.uint8).reshape(shape)
    _verify_footer(f, filename, blob, gb)
    return payload, gb


def load_binary(filename: str, config=None) -> Dataset:
    """Load a binary dataset cache.  With ``config``, the run's
    resolved ``bin_packing`` is checked against the file's recorded
    layout.  A 4bit run refuses an unpacked cache loudly (4bit is
    never a default — if it resolved, the user asked for it).  A
    packed cache under an 8bit config loads WITH A WARNING and keeps
    its recorded layout: "8bit" is also the default, so a refusal
    would lock a default-params run out of the cache it just built —
    and no mis-binning is possible either way, because every consumer
    reads through the dataset's self-describing ``bin_layout`` (and a
    pre-packing build refuses the v3 version outright).  ``auto``
    accepts whatever layout the cache carries."""
    with _open(filename, "rb") as f:
        token = f.read(len(BINARY_TOKEN))
        if token != BINARY_TOKEN:
            Log.fatal(f"{filename} is not a lightgbm_tpu binary dataset")
        magic = f.read(len(MAGIC_V2))
        if magic == MAGIC_V2:
            payload, group_bins = _read_v2(f, filename)
            version = int(payload.get("version", 2))
        else:
            # v1: the bytes just read are the head of the pickle stream
            Log.warning(
                f"{filename} is a v1 (pickle-payload) binary dataset — "
                "loading works but costs a full in-RSS copy of the bin "
                "matrix; re-save it to get the memmap-able v2 format")
            try:
                payload = _loads(magic + f.read())
            except Exception as e:
                Log.fatal(f"{filename}: corrupted v1 binary dataset "
                          f"({type(e).__name__}: {e})")
            if payload.get("version") != 1:
                Log.fatal("Unsupported binary dataset version "
                          f"{payload.get('version')!r}")
            group_bins = payload["group_bins"]
            version = 1
    ds = _restore_dataset(payload, group_bins)
    if config is not None:
        _check_packing(filename, ds, config)
    Log.info(f"Loaded binned dataset from binary file {filename} "
             f"(v{version})")
    return ds


def _check_packing(filename: str, ds: Dataset, config) -> None:
    """Loud layout/intent mismatch handling (see load_binary)."""
    from .packing import resolve_bin_packing
    want = resolve_bin_packing(config)
    lay = ds.bin_layout
    if want == "8bit" and lay is not None:
        Log.warning(
            f"{filename}: cache holds a nibble-packed bin matrix "
            f"({lay!r}); bin_packing=8bit applies to NEW "
            "constructions — the cached layout is kept as recorded "
            "(delete the file and re-save from an 8bit construction "
            "for an unpacked cache)")
    if want == "4bit" and lay is None:
        Log.fatal(
            f"{filename}: cache holds an 8-bit bin matrix but this "
            "run asked for bin_packing=4bit — the cached EFB group "
            "layout differs from a 4-bit construction; rebuild the "
            "cache under bin_packing=4bit (delete the file) or run "
            "with bin_packing=auto/8bit")
    if want == "2bit" and (lay is None or lay.crumb_groups == 0):
        Log.fatal(
            f"{filename}: cache holds "
            + ("an 8-bit" if lay is None else "a crumb-free packed")
            + " bin matrix but this run asked for bin_packing=2bit — "
            "the cached group layout differs from a 2-bit "
            "construction; rebuild the cache under bin_packing=2bit "
            "(delete the file) or run with bin_packing=auto/8bit")


def _restore_dataset(payload: dict, group_bins) -> Dataset:
    """Rebuild a Dataset from a cache payload (either version)."""
    from .binning import BIN_CATEGORICAL
    from .dataset import FeatureView, Metadata

    ds = Dataset.__new__(Dataset)
    Dataset.__init__(ds)
    from .packing import BinLayout
    ds.num_data = payload["num_data"]
    ds.num_total_features = payload["num_total_features"]
    ds.mappers = payload["mappers"]
    ds.used_features = payload["used_features"]
    ds.group_bins = group_bins
    # pre-packing caches carry no layout field -> 8-bit storage
    ds.bin_layout = BinLayout.from_state(payload.get("bin_packing"))
    ds.group_num_bin = payload["group_num_bin"]
    ds.group_is_multi = payload["group_is_multi"]
    ds._bundles = payload["bundles"]
    ds.feature_names = payload["feature_names"]
    ds.max_bin = payload["max_bin"]
    ds._categorical_features = payload["categorical_features"]
    ds.monotone_constraints = payload["monotone"]
    for m in ds.mappers:
        # categorical lookup cache: mappers pickled by an older version
        # lack the slot — rebuild now so per-chunk binning against a
        # reloaded cache never re-materializes the dict arrays
        if m.bin_type == BIN_CATEGORICAL \
                and getattr(m, "_cat_lut", None) is None:
            m._build_cat_cache()
    # rebuild FeatureView list from bundles + mappers
    feats = []
    for gidx, bundle in enumerate(ds._bundles):
        if len(bundle) == 1:
            fidx = bundle[0]
            feats.append(FeatureView(fidx, gidx, 0, 0, ds.mappers[fidx],
                                     collapsed_default=False))
        else:
            total = 1
            for sub, fidx in enumerate(bundle):
                m = ds.mappers[fidx]
                offset = total
                nb = m.num_bin - (1 if m.default_bin == 0 else 0)
                feats.append(FeatureView(fidx, gidx, sub, offset, m,
                                         collapsed_default=True))
                total += nb
    feats.sort(key=lambda f: f.feature_idx)
    ds.features = feats
    ds.metadata = Metadata(ds.num_data)
    ds.metadata.label = payload["label"]
    ds.metadata.weight = payload["weight"]
    ds.metadata.query_boundaries = payload["query_boundaries"]
    ds.metadata.init_score = payload["init_score"]
    return ds
