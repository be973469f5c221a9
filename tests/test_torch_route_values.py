"""Kernel B's row values as the CUDA kernel derives them.

The exit-route kernel (lightgbm_tpu_torch/csrc/route_apply.cu) takes
the (L,) f32 leaf values and derives each leaf's bf16-split keep and
right-child values itself: hi = v & 0xFFFF0000, mid = (v - hi) &
0xFFFF0000, lo = ((v - hi) - mid) & 0xFFFF0000 on the f32 bits, summed
as (hi + mid) + lo in f32 round to nearest, the right child's id t[8] *
256 + t[9] clamped to [0, L - 1].  A numpy model of exactly those
operations is held here bit for bit against the JAX package's
_split3_bf16 and the JAX package's (the columns the TPU kernel sums), on
signed zeros, subnormals, values near 2^-100 and 2^100 and random f32,
and the model's row values against the port's plain version of kernel B
(the six table columns) and the JAX exit route in interpret mode.  The
kernel itself runs on the card (tests/test_torch_cuda.py).

XLA on the CPU (and a TPU) flushes subnormal f32 operands and results to
zero; torch and the CUDA kernel (built without fast math) keep them.
The JAX package is therefore matched on the values none of whose parts,
differences or sums is subnormal (every leaf value above ~2^-102 in
magnitude), the port on all of them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram as JH
from lightgbm_tpu.ops import partition as JP
from lightgbm_tpu_torch.ops import histogram as TH
from lightgbm_tpu_torch.ops import partition as TP

MASK = np.uint32(0xFFFF0000)


def _trunc(x):
    return (x.astype(np.float32).view(np.uint32) & MASK).view(np.float32)


def split3_sum_model(v):
    """The kernel's split3_sum on an f32 array: numpy f32 arithmetic is
    IEEE single precision, round to nearest, no flush of subnormals."""
    v = np.asarray(v, np.float32)
    hi = _trunc(v)
    r1 = (v - hi).astype(np.float32)
    mid = _trunc(r1)
    lo = _trunc((r1 - mid).astype(np.float32))
    return ((hi + mid).astype(np.float32) + lo).astype(np.float32)


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _normal_parts(v):
    """Where none of the model's operands, differences and sums for v
    is subnormal (XLA's CPU and the TPU flush those to zero)."""
    v = np.asarray(v, np.float32)
    hi = _trunc(v)
    r1 = (v - hi).astype(np.float32)
    mid = _trunc(r1)
    r2 = (r1 - mid).astype(np.float32)
    lo = _trunc(r2)
    hm = (hi + mid).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    ok = np.ones(v.shape, bool)
    for x in (v, hi, r1, mid, r2, lo, hm, hm + lo):
        ok &= (x == 0) | (np.abs(x) >= tiny)
    return ok


EDGES = {
    "signed zeros": [0.0, -0.0],
    "subnormals": [1e-45, -1e-45, 1.4e-40, -5.9e-39, 1.1754942e-38],
    "near 2^-100": [2.0 ** -100, -(2.0 ** -100) * 1.2345678,
                    (2.0 ** -100) * 1.9999999, 2.0 ** -101 * 1.5],
    "near 2^100": [2.0 ** 100, -(2.0 ** 100) * 1.9999999,
                   (2.0 ** 100) * 1.0000001, 2.0 ** 99 * 1.75],
    "low mantissa bits": [1.0000001, 65535.996, 3.1415927, -0.33333334,
                          6.1e-5, 1.0, -1.0],
}


def _values(case):
    if case == "random f32":
        rng = np.random.RandomState(9)
        bits = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(
            np.uint32)
        v = bits.view(np.float32)
        return v[np.isfinite(v)]
    return np.array(EDGES[case], np.float32)


@pytest.mark.parametrize("case", list(EDGES) + ["random f32"])
def test_split3_model_equals_both_packages(case):
    """The kernel's arithmetic, modelled in numpy, equals (hi + mid) + lo
    of the JAX package's and the port's _split3_bf16 bit for bit."""
    v = _values(case)
    got = split3_sum_model(v)
    th, tm, tl = (c[:, 0] for c in TP._split3_bf16(torch.from_numpy(v)))
    want_port = ((th + tm) + tl).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want_port))
    jh, jm, jl = (np.asarray(c).ravel()
                  for c in JP._split3_bf16(jnp.asarray(v)))
    want_jax = ((jh + jm).astype(np.float32) + jl).astype(np.float32)
    ok = _normal_parts(v)
    assert ok.sum() >= (0 if case == "subnormals" else len(v) // 2)
    np.testing.assert_array_equal(_bits(got)[ok], _bits(want_jax)[ok])


def _route_case(seed, N=2048, G=5, B=16, L=40):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, (N, G)).astype(np.uint8)
    leaf = rng.randint(0, L, N).astype(np.int32)
    leaf[rng.rand(N) < 0.05] = -1
    leaf[rng.rand(N) < 0.05] += L                  # past the table
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    rs = rng.randint(0, 2 * L, L)                  # some past L: clamped
    tab = TP.build_route_table(
        t(rng.rand(L) < 0.6), t(rng.randint(0, G, L)), torch.zeros(L),
        torch.full((L,), B), torch.zeros(L), torch.full((L,), B - 1),
        t(rng.rand(L) < 0.25), t(rng.randint(0, B - 1, L)),
        t(rng.rand(L) < 0.5), t(rng.randint(0, 3, L)),
        t(rng.randint(0, B, L)), torch.full((L,), B),
        t(rng.rand(L, B) < 0.5), t(rs))
    vals = (rng.randn(L) * 2.0 ** rng.randint(-20, 20, L)).astype(
        np.float32)
    vals[:len(EDGES["subnormals"])] = EDGES["subnormals"]
    vals[-2:] = [-0.0, 2.0 ** 100]
    return bins, leaf, tab, vals


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_route_value_model_equals_plain_and_jax(seed):
    """Row values from the per-leaf (keep, right) pairs the kernel builds
    (the model above, the clamp of the right child's id, 0.0 on a
    negative leaf or one past the table) equal the port's plain kernel B
    and the JAX exit route in interpret mode, bit for bit."""
    bins, leaf, tab, vals = _route_case(seed)
    L = vals.shape[0]
    t = tab.numpy()
    rs = t[:, 8].astype(np.int32) * 256 + t[:, 9].astype(np.int32)
    keep = split3_sum_model(vals)
    right = split3_sum_model(vals[np.clip(rs, 0, L - 1)])
    new_leaf, went_right = TP.route_rows(
        TP.gather_route_rows(tab, torch.from_numpy(leaf)),
        torch.from_numpy(leaf),
        TP.chosen_group_bins(torch.from_numpy(bins),
                             TP.gather_route_rows(tab,
                                                  torch.from_numpy(leaf))),
        with_decision=True)
    ok = (leaf >= 0) & (leaf < L)
    lc = np.clip(leaf, 0, L - 1)
    model = np.where(ok, np.where(went_right.numpy(), right[lc], keep[lc]),
                     np.float32(0.0)).astype(np.float32)
    tl, tv = TH.route_apply_plain(torch.from_numpy(np.ascontiguousarray(
        bins.T)), torch.from_numpy(leaf), tab, torch.from_numpy(vals))
    np.testing.assert_array_equal(tl.numpy(), new_leaf.numpy())
    np.testing.assert_array_equal(_bits(model), _bits(tv.numpy()))
    jl, jv = JH.route_apply_tiled(jnp.asarray(bins.T), jnp.asarray(leaf),
                                  jnp.asarray(t), jnp.asarray(vals),
                                  block=256, interpret=True)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    normal = _normal_parts(vals)
    rows = ~ok | np.where(went_right.numpy(), normal[np.clip(rs, 0, L - 1)][lc],
                          normal[lc])
    assert rows.mean() > 0.8
    np.testing.assert_array_equal(_bits(np.asarray(jv))[rows],
                                  _bits(model)[rows])
