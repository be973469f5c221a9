"""Guards of the port: it stands apart from JAX, it runs on the CUDA
device unless asked for the CPU, and its smoke script fails without a
card or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as tlgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lightgbm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "lightgbm_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _bad_import(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports_in_port(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_bad_import(n) for n in names), (path, names)


def test_import_leaves_jax_unloaded():
    code = ("import sys, lightgbm_tpu_torch\n"
            "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'lightgbm_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'lightgbm_tpu.'))]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _xy(n=300):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 4)
    return X, (X[:, 0] > 0).astype(float)


_MAIN = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "quantized_grad": True, "hist_compute_dtype": "bfloat16"}


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _xy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlgb.train(_MAIN, tlgb.Dataset(X, label=y), 2, verbose_eval=False)
    bst = tlgb.train(dict(_MAIN, device="cpu"), tlgb.Dataset(X, label=y), 2,
                     verbose_eval=False)
    text = bst.model_to_string()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlgb.Booster(model_str=text).predict(X)
    assert tlgb.Booster(model_str=text, params={"device": "cpu"}).predict(
        X).shape == (X.shape[0],)


def test_default_config_trains_on_the_cpu():
    """{"objective": "binary"} and nothing else but the CPU device:
    the default hist_compute_dtype=float32 resolves the xla plan."""
    X, y = _xy()
    bst = tlgb.train({"objective": "binary", "device": "cpu"},
                     tlgb.Dataset(X, label=y), 3, verbose_eval=False,
                     keep_training_booster=True)
    assert bst.gbdt.grower.plan.name == "xla"
    assert bst.num_trees() == 3
    p = bst.predict(X)
    assert np.isfinite(p).all() and ((p > 0.5) == (y > 0)).mean() > 0.9


def test_unported_plans_raise():
    X, y = _xy()
    # the data learner trains (on the CPU: a mesh of the CPU's virtual
    # shards, on the xla plan), as do the feature and voting learners
    # and sharded construction; the cross-process device plane resolves
    # (tests/test_torch_distributed.py trains on it)
    bst = tlgb.train(dict(_MAIN, device="cpu", tree_learner="data"),
                     tlgb.Dataset(X, label=y), 1, verbose_eval=False,
                     keep_training_booster=True)
    assert bst.gbdt.grower.sharded and bst.gbdt.grower.plan.name == "xla"
    from lightgbm_tpu_torch.parallel import transport
    assert transport.resolve_transport_mode(
        tlgb.Config(collective_transport="xla"), 2) == "xla"
    with pytest.raises(ValueError, match="device"):
        tlgb.Config.from_params({"device": "tpu"})


def test_smoke_script_fails_without_card_or_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
