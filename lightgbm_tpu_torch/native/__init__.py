"""Native (C++) host library, bound with ctypes: the text parser and
the dense binner (port of lightgbm_tpu/native/__init__.py).

``src/*.cpp`` is built with ``g++`` at first use into ``build/native/``
beside the package, named by a hash of the sources, the flags and the
host CPU (``-march=native`` code may not run on another CPU), so a
changed source or host rebuilds and an unchanged one loads at once; nothing is
built at import.  The library is host IO, not the device: when it
cannot be built (no ``g++``), one warning is logged, :func:`loaded`
stays False and the callers parse with numpy and bin with the Python
mappers, which give the same bytes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

from ..utils.log import Log

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
GXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-std=c++17",
             "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
#: why the library did not load ("" while it loaded or was not asked for)
LOAD_ERROR = ""


def _sources():
    return [os.path.join(_SRC_DIR, f) for f in sorted(os.listdir(_SRC_DIR))
            if f.endswith(".cpp")]


def _host_cpu() -> str:
    """The machine and its CPU's feature flags, which ``-march=native``
    compiles for."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    flags = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{platform.machine()} {flags or platform.processor()}"


def lib_path() -> str:
    """Where the library of the current sources is (or will be) built
    for this host."""
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu().encode())
    for s in _sources():
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libltpu_{h.hexdigest()[:12]}.so")


def _build() -> str:
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, *_sources()], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> None:
    """The signature of every entry point the port calls, in one
    place."""
    dp, lp = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long)
    up = ctypes.POINTER(ctypes.c_ubyte)
    lib.ltpu_load_csv.restype = dp
    lib.ltpu_load_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.ltpu_free.argtypes = [dp]
    lib.ltpu_bin_dense.restype = None
    lib.ltpu_bin_dense.argtypes = [dp, ctypes.c_long, ctypes.c_long, lp,
                                   ctypes.c_long, dp, lp, up, lp, up]
    lib.ltpu_bin_dense_mt.restype = None
    lib.ltpu_bin_dense_mt.argtypes = [dp, ctypes.c_long, ctypes.c_long, lp,
                                      ctypes.c_long, dp, lp, up, lp, up,
                                      ctypes.c_long]
    lib.ltpu_scatter_cols.restype = None
    lib.ltpu_scatter_cols.argtypes = [up, ctypes.c_long, ctypes.c_long, lp,
                                      up, ctypes.c_long]
    lib.ltpu_bin_cat.restype = None
    lib.ltpu_bin_cat.argtypes = [
        dp, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_long, ctypes.c_long, up,
        ctypes.c_long]
    lib.ltpu_pack_nibbles.restype = None
    lib.ltpu_pack_nibbles.argtypes = [up, ctypes.c_long, ctypes.c_long,
                                      ctypes.c_long, up, ctypes.c_long]
    lib.ltpu_bin_bundle.restype = None
    lib.ltpu_bin_bundle.argtypes = [up, ctypes.c_long, ctypes.c_long,
                                    ctypes.c_long, up, ctypes.c_long]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None (after one
    warning) when it cannot be built or loaded."""
    global _lib, _build_failed, LOAD_ERROR
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            lib = ctypes.CDLL(_build())
            _bind(lib)
        except (subprocess.CalledProcessError, OSError,
                AttributeError) as e:
            detail = getattr(e, "stderr", "") or ""
            LOAD_ERROR = f"{type(e).__name__}: {e} {detail}".strip()
            _build_failed = True
            Log.warning(f"native host library unavailable ({LOAD_ERROR}); "
                        "parsing with numpy and binning with the Python "
                        "mappers")
            return None
        _lib = lib
        return _lib


def loaded() -> bool:
    """Whether the native library is loaded (building it if needed)."""
    return get_lib() is not None


class text_loader:
    """The native parser (used by data_loader.py)."""

    @staticmethod
    def load_csv(path: str, sep: str, skip_rows: int) -> np.ndarray:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        rows = ctypes.c_int64()
        cols = ctypes.c_int64()
        ptr = lib.ltpu_load_csv(path.encode(), sep.encode(), skip_rows,
                                ctypes.byref(rows), ctypes.byref(cols))
        if not ptr:
            raise RuntimeError(f"native parse failed for {path}")
        try:
            n = rows.value * cols.value
            arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        finally:
            lib.ltpu_free(ptr)
        return arr.reshape(rows.value, cols.value)
