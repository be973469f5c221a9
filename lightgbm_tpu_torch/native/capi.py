"""The ``LGBM_*`` C library of the port: ``liblgbm_tpu_torch.so``, an
embedded CPython forwarding each C call to :mod:`lightgbm_tpu_torch.capi`
(port of the JAX package's ``liblgbm_tpu.so``; sources
``src/capi/c_api_embed.cpp`` and ``include/lightgbm_tpu_c_api.h``).

:func:`build_capi` builds it with ``g++`` at first use into
``build/capi/<hash>/`` beside the package, the hash covering the
sources, the header, the flags and the Python it links; an unchanged
tree loads the built file at once.  Python's include directory and
library come from ``sysconfig`` (``python3-config --embed`` where the
interpreter has no shared library).  A failed build raises with g++'s
messages: a C host has nothing to fall back to.

Drive it from C: compile against :func:`include_dir`, link with
``-L <dir of build_capi()> -llgbm_tpu_torch -Wl,-rpath,<that dir>``, put
the repo on ``PYTHONPATH`` (or call ``LTPU_AddSysPath``) and leave with
``_exit`` (native/README.md).  From Python: ``ctypes.PyDLL(build_capi())``
shares the running interpreter.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from typing import List

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "capi")
SOURCE = os.path.join(_HERE, "src", "capi", "c_api_embed.cpp")
HEADER = os.path.join(_HERE, "include", "lightgbm_tpu_c_api.h")
LIB_NAME = "liblgbm_tpu_torch.so"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()


def include_dir() -> str:
    """The directory holding ``lightgbm_tpu_c_api.h``."""
    return os.path.dirname(HEADER)


def _python_flags() -> List[str]:
    """Compile and link flags of the running Python: its headers, and
    its shared library with an rpath to it (else ``python3-config
    --embed``'s link line)."""
    cv = sysconfig.get_config_var
    inc = [f"-I{cv('INCLUDEPY')}"]
    libdir, ldlib = cv("LIBDIR"), cv("LDLIBRARY") or ""
    if cv("Py_ENABLE_SHARED") and ldlib.startswith("lib") and \
            ".so" in ldlib:
        name = ldlib[3:ldlib.index(".so")]
        return inc + [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}",
                      *(cv("LIBS") or "").split(),
                      *(cv("SYSLIBS") or "").split()]
    exe = shutil.which(f"python{sys.version_info.major}."
                       f"{sys.version_info.minor}-config") \
        or shutil.which("python3-config")
    if exe is None:
        raise RuntimeError(
            "building the C API library needs libpython: this Python has "
            f"no shared library ({ldlib!r} in {libdir}) and no "
            "python3-config")
    ld = subprocess.run([exe, "--ldflags", "--embed"], capture_output=True,
                        text=True, check=True).stdout.split()
    return inc + ld


def lib_path(flags: List[str]) -> str:
    """Where the library of the current sources and ``flags`` is (or
    will be) built."""
    h = hashlib.sha1(" ".join(GXX_FLAGS + tuple(flags)).encode())
    h.update(sys.version.encode())
    for p in (SOURCE, HEADER):
        with open(p, "rb") as fh:
            h.update(os.path.basename(p).encode() + fh.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:12], LIB_NAME)


def build_capi() -> str:
    """The path of ``liblgbm_tpu_torch.so`` for the current sources,
    built with ``g++`` first if it is not there.  Raises RuntimeError
    with g++'s messages when the build fails."""
    flags = _python_flags()
    path = lib_path(flags)
    with _lock:
        if os.path.exists(path):
            return path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        cpp = [f for f in flags if f.startswith("-I")]
        ld = [f for f in flags if not f.startswith("-I")]
        run = subprocess.run(["g++", *GXX_FLAGS, *cpp, SOURCE, "-o", tmp,
                              *ld], capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"building {LIB_NAME} failed:\n"
                               f"{run.stderr[-4000:]}")
        os.replace(tmp, path)
        return path


__all__ = ["build_capi", "include_dir", "lib_path", "BUILD_DIR"]
