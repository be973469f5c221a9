"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
``sm_90a`` (Hopper) into a shared library with a plain C interface and
loaded with ``ctypes``.  The libraries go to ``build/kernels/`` next to
the package, named by a hash of the source and flags, so a changed
source rebuilds and an unchanged one loads at once.  Nothing is built
or loaded at import: the first wrapper call on a CUDA tensor (or an
explicit :func:`build_kernels`) does it, and every source is compiled
in parallel.  Several kernel names may share one source (a template
with one C entry point per variant) or one C entry point: the streamed
one-hot histogram serves three entry points, the f32 bin-matrix
histogram two (F, K) and the int8 one two, each counted under its own
name.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its path went through the kernels (``reset_launches`` zeroes
them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# the f32 histograms take a launch plan (an int64 array from
# ops/histogram.py HistPlan.as_args); the streamed one-hot's entry point
# then the pack spec of its routing's bins (packing.py pack_spec, 0:
# byte-wide) before the stream
_ONEHOT_ARGS = [_P, _I64, _I, _P, _P, _I64, _I64, _I, _P, _P, _P, _P, _P,
                _I64, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P]
_BINS_F64_ARGS = [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _P, _P]
# the int32 histograms G and I: inputs, hist, n, G, B, W, then the plan
# of ops/histogram.py frontier_hist_plan and its scratch before the
# stream; the transposed ones (A, G) and J and the routes B and H also
# take the pack spec of their bins (packing.py pack_spec, 0: byte-wide)
# before the stream
_I32_ARGS = [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P, _P, _P]
# kernel name -> (source file, C entry point, argtypes)
KERNELS: Dict[str, tuple] = {
    # kernel A takes the plan and scratch of G and I
    "fused_route_hist": (
        "fused_route_hist.cu", "ltt_fused_route_hist",
        [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _P, _P,
         _I, _P]),
    # kernel G: kernel A's histogram without the routing
    "tiled_hist": ("fused_route_hist.cu", "ltt_tiled_hist",
                   _I32_ARGS[:-1] + [_I, _P]),
    # kernel B: the pending route table, the leaf values and the SMs
    "route_apply": (
        "route_apply.cu", "ltt_route_apply",
        [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _P]),
    # kernel H: kernel B's template without the row values
    "route_only": ("route_apply.cu", "ltt_route_only",
                   [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _P]),
    # kernel C's two tiers: the records in shared memory, chunk by chunk
    # (the main path's batches), and read from device memory (small
    # batches)
    "predict_level": (
        "predict_level.cu", "ltt_predict_level",
        [_P] * 6 + [_I64] + [_I] * 14 + [_P]),
    "predict_level_global": (
        "predict_level.cu", "ltt_predict_level_global",
        [_P] * 7 + [_I64] + [_I] * 10 + [_P]),
    # kernel D (routing on) and kernel E's two entry points (routing
    # off) share one source and one C entry point
    "fused_onehot_hist": ("onehot_hist.cu", "ltt_onehot_hist",
                          _ONEHOT_ARGS),
    "hist_pre_packed": ("onehot_hist.cu", "ltt_onehot_hist", _ONEHOT_ARGS),
    "hist_pre": ("onehot_hist.cu", "ltt_onehot_hist", _ONEHOT_ARGS),
    "bins_hist": ("bins_hist.cu", "ltt_bins_hist", _BINS_F64_ARGS),
    # kernel K: F's template behind the pallas_paired plan
    "bins_hist_paired": ("bins_hist.cu", "ltt_bins_hist_paired",
                         _BINS_F64_ARGS),
    # kernel I (int8 weights, G's histogram on the row-major layout)
    # behind its two entry points
    "bins_hist_q": ("bins_hist.cu", "ltt_bins_hist_q", _I32_ARGS),
    "bins_hist_q_packed": ("bins_hist.cu", "ltt_bins_hist_q", _I32_ARGS),
    # kernel J: the int8 histogram of leaf-partitioned rows, then its
    # plan (ops/histogram.py SegPlan) and the run plan's scratch
    "seg_hist": ("seg_hist.cu", "ltt_seg_hist",
                 [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _P, _P, _I, _P]),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas resource report (registers, shared memory, spills) per source
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "lightgbm_tpu_torch/csrc at first use and need the "
                       "CUDA toolkit (PATH or CUDA_HOME)")


def _lib_path(src: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")) and (f == src or f.endswith(".cuh")):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:12]}.so")


def build_kernels(names: Optional[list] = None) -> Dict[str, str]:
    """Compile every missing kernel library, one ``nvcc`` per source,
    all started together.  Returns {kernel name: library path}; raises
    with the compiler's output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = sorted({KERNELS[n][0] for n in names})
    paths = {s: _lib_path(s) for s in srcs}
    procs = {}
    nvcc = None
    for s in srcs:
        if os.path.exists(paths[s]):
            continue
        nvcc = nvcc or _nvcc()
        tmp = paths[s] + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for s, (p, tmp) in procs.items():
        out, _ = p.communicate()
        BUILD_LOG[s] = out
        if p.returncode != 0:
            failed.append(f"{s} (nvcc exit {p.returncode}):\n{out}")
            continue
        os.replace(tmp, paths[s])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {n: paths[KERNELS[n][0]] for n in names}


def get_kernel(name: str):
    """The ctypes entry point of kernel ``name``, building and loading
    its source's library on first use."""
    src, sym, argtypes = KERNELS[name]
    lib = _LIBS.get(src)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(src)
            if lib is None:
                lib = ctypes.CDLL(build_kernels([name])[name])
                _LIBS[src] = lib
    fn = getattr(lib, sym)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current CUDA stream (the stream is
    appended to ``args``), count the launch, and raise on a nonzero
    ``cudaGetLastError`` from the launch."""
    import torch
    fn = get_kernel(name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
