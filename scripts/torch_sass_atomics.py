#!/usr/bin/env python3
"""What the port's histogram atomics compile to on sm_90a.

    python3 scripts/torch_sass_atomics.py     # on a machine with nvcc

1. Compiles a probe (one atomicAdd each on a shared f64, f32 and int32
   address and on a global f64 address) for sm_90a and prints the SASS
   atomic instructions of each: a native add (ATOMS.ADD, REDG.E.ADD) or
   a compare-and-swap loop (ATOMS.CAST.SPIN).
2. Builds the port's kernel libraries (lightgbm_tpu_torch/csrc) and
   counts, for every kernel function, its shared CAS loops, shared
   atomics and other atomics (global, or generic where the compiler
   cannot tell a pointer's space, e.g. across a call).
3. Checks that the int32 histogram (hist_i32.cuh) compiles to no shared
   compare-and-swap loop (ATOMS.CAST.SPIN) and that its shared adds are
   native ATOMS.ADD, in both libraries that hold it: fused_route_hist.cu
   (kernels A and G, the transposed layout) and bins_hist.cu (kernel I,
   the row-major layout, beside kernels F and K, whose whole library
   must hold no shared CAS loop either); exits 1 otherwise.

Needs nvcc and cuobjdump (the CUDA toolkit), no card.  Output goes to
standard output and chiprun_out/sass_atomics.txt (the full listing).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE = r"""
#include <cstdint>
#define PROBE(name, T)                                                   \
  __global__ void name(T* out, const T* in, const int* idx) {            \
    __shared__ T h[1024];                                                \
    for (int i = threadIdx.x; i < 1024; i += blockDim.x) h[i] = 0;       \
    __syncthreads();                                                     \
    atomicAdd(&h[idx[threadIdx.x] & 1023], in[threadIdx.x]);             \
    __syncthreads();                                                     \
    out[threadIdx.x] = h[threadIdx.x];                                   \
  }
PROBE(shared_f64, double)
PROBE(shared_f32, float)
PROBE(shared_i32, int)
__global__ void global_f64(double* out, const double* in, const int* idx) {
  atomicAdd(&out[idx[threadIdx.x] & 1023], in[threadIdx.x]);
}
"""

ATOMIC = re.compile(r"\b(ATOMS\.\S+|ATOMG\.\S+|ATOM\.\S+|REDG\.\S+|RED\.\S+)")


def sass_by_function(path: str) -> dict:
    """{mangled function name: [SASS atomic opcodes]} of a cubin or
    shared library."""
    out = subprocess.run(["cuobjdump", "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
        elif cur is not None:
            funcs[cur] += ATOMIC.findall(line)
    return funcs, out


def main() -> int:
    from lightgbm_tpu_torch.ops import kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    build = os.path.join(ROOT, "build", "sass_probe")
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "probe.cu")
    with open(src, "w") as fh:
        fh.write(PROBE)
    cubin = os.path.join(build, "probe.cubin")
    subprocess.run([kernels._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-cubin", "-o",
                    cubin, src], check=True)
    listing = []
    funcs, text = sass_by_function(cubin)
    listing.append(text)
    print("probe (sm_90a): atomicAdd compiles to")
    for name, ops in sorted(funcs.items()):
        print(f"  {name}: {', '.join(ops) or 'no atomic'}")
    libs = sorted(set(kernels.build_kernels().values()))
    print("kernel functions: shared CAS loops / shared atomics / global "
          "or generic atomics")
    # library prefix -> its shared CAS loops and the int32 histogram's
    # native shared adds
    i32 = {p: {"cas": 0, "adds": 0} for p in ("libfused_route_hist_",
                                               "libbins_hist_")}
    for lib in libs:
        funcs, text = sass_by_function(lib)
        listing.append(text)
        for name, ops in sorted(funcs.items()):
            cas = sum(o.startswith("ATOMS.CAS") for o in ops)
            shared = sum(o.startswith("ATOMS") for o in ops) - cas
            glob = sum(not o.startswith("ATOMS") for o in ops)
            print(f"  {os.path.basename(lib)} {name}: {cas} / {shared} / "
                  f"{glob}  ({', '.join(sorted(set(ops))) or '-'})")
            for prefix, c in i32.items():
                if os.path.basename(lib).startswith(prefix):
                    c["cas"] += cas
                    if "hist_i32_kernel" in name:
                        c["adds"] += sum(o.startswith("ATOMS.ADD")
                                         for o in ops)
    with open(os.path.join(ROOT, "chiprun_out", "sass_atomics.txt"),
              "w") as fh:
        fh.write("\n".join(listing))
    ok = True
    for (prefix, c), what in zip(i32.items(), ("fused_route_hist.cu "
                                               "(kernels A, G)",
                                               "bins_hist.cu (kernel I; "
                                               "F, K)")):
        good = c["cas"] == 0 and c["adds"] > 0
        ok &= good
        print(f"{what}: {c['cas']} shared CAS loops (0 expected), "
              f"{c['adds']} native shared ATOMS.ADD in the int32 "
              f"histogram: {'ok' if good else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
