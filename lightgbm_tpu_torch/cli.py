"""Command-line application: train / predict / convert_model / refit
(port of lightgbm_tpu/cli.py).

The analog of the reference CLI driver (reference: src/main.cpp,
src/application/application.cpp:30-268 — param parsing with config
file + k=v args, task dispatch, data loading, prediction output file).
Training and prediction run on the CUDA device unless ``device=cpu``
is given; without a CUDA device the run raises.  ``task=serve`` and
``num_machines > 1`` are refused: the serving and distributed modules
are not ported yet (ROADMAP.md, queue 1).

Usage:  python -m lightgbm_tpu_torch config=train.conf [key=value ...]
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from .basic import Dataset
from .booster import Booster
from .config import Config
from .engine import train as _train
from .utils.device import resolve_device
from .utils.log import Log


def parse_args(argv: List[str]) -> Dict[str, str]:
    """CLI `k=v` pairs + config file contents, CLI wins
    (reference application.cpp:48-81)."""
    cli: Dict[str, str] = {}
    for tok in argv:
        if "=" in tok:
            k, v = tok.split("=", 1)
            cli[k.strip()] = v.strip()
    params: Dict[str, str] = {}
    cfg_file = cli.get("config", cli.get("config_file"))
    if cfg_file:
        with open(cfg_file) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if "=" in line:
                    k, v = line.split("=", 1)
                    params[k.strip()] = v.strip()
    params.update(cli)
    return params


def run(argv: List[str]) -> int:
    params = parse_args(argv)
    config = Config.from_params(params)
    Log.set_level(config.verbose)
    task = config.task
    if task == "serve":
        Log.fatal("task=serve is not ported yet (the serving modules, "
                  "ROADMAP.md queue 1)")
    if task == "train":
        _task_train(params, config)
    elif task in ("predict", "prediction", "test"):
        _task_predict(params, config)
    elif task == "convert_model":
        _task_convert(params, config)
    elif task == "refit":
        _task_refit(params, config)
    else:
        Log.fatal(f"Unknown task {task}")
    return 0


def _task_train(params, config: Config) -> None:
    if not config.data:
        Log.fatal("No training data: set data=<file>")
    if config.num_machines > 1:
        Log.fatal("num_machines > 1: distributed training is not ported "
                  "yet (ROADMAP.md queue 1)")
    resolve_device(config)
    # input_model (continued training) seeds scores from the raw rows,
    # so they are kept in that case
    train_set = Dataset(config.data, params=params,
                        free_raw_data=not config.input_model)
    if config.is_save_binary_file:
        # written at load time, as the reference's DatasetLoader does:
        # the core built here is the one the training run below uses
        train_set.save_binary(config.data + ".bin")
        Log.info(f"Saved binned dataset to {config.data}.bin")
    valid_sets = []
    valid_names = []
    for i, vf in enumerate(config.valid_data):
        valid_sets.append(Dataset(vf, reference=train_set, params=params))
        valid_names.append(f"valid_{i}" if len(config.valid_data) > 1
                           else "valid_1")
    booster = _train(params, train_set, config.num_iterations,
                     valid_sets=valid_sets, valid_names=valid_names,
                     init_model=config.input_model or None)
    booster.save_model(config.output_model)
    Log.info(f"Finished training; model saved to {config.output_model}")


def write_predictions(path: str, pred: np.ndarray, n_rows: int) -> None:
    """One line a row, its outputs tab-separated in ``%g``."""
    out = np.atleast_2d(np.asarray(pred))
    if out.shape[0] == 1 and n_rows != 1:
        out = out.T
    with open(path, "w") as f:
        for row in (out if out.ndim > 1 else out[:, None]):
            f.write("\t".join(f"{v:g}" for v in np.atleast_1d(row)) + "\n")


def _task_predict(params, config: Config) -> None:
    if not config.input_model:
        Log.fatal("No model file: set input_model=<file>")
    resolve_device(config)
    # the parsed config rides along, so the predict keys of the command
    # line reach the serving predictor
    booster = Booster(config=config, model_file=config.input_model)
    if config.predict_warm_buckets:
        booster.warm_predictor(config.predict_warm_buckets, log=True)
    from .data_loader import load_file
    X, _, _ = load_file(config.data, config)
    pred = booster.predict(
        X,
        num_iteration=config.num_iteration_predict,
        raw_score=config.is_predict_raw_score,
        pred_leaf=config.is_predict_leaf_index,
        pred_contrib=config.is_predict_contrib,
        pred_early_stop=config.pred_early_stop,
        pred_early_stop_freq=config.pred_early_stop_freq,
        pred_early_stop_margin=config.pred_early_stop_margin)
    write_predictions(config.output_result, pred, X.shape[0])
    Log.info(f"Finished prediction; results saved to "
             f"{config.output_result}")


def _task_convert(params, config: Config) -> None:
    if not config.input_model:
        Log.fatal("No model file: set input_model=<file>")
    if config.convert_model_language not in ("", "cpp"):
        Log.fatal("Only cpp is supported for convert_model_language")
    booster = Booster(config=config, model_file=config.input_model)
    from .codegen import model_to_ifelse_cpp
    code = model_to_ifelse_cpp(booster)
    with open(config.convert_model, "w") as f:
        f.write(code)
    Log.info(f"Finished converting model to if-else code at "
             f"{config.convert_model}")


def _task_refit(params, config: Config) -> None:
    if not config.input_model:
        Log.fatal("No model file: set input_model=<file>")
    resolve_device(config)
    booster = Booster(config=config, model_file=config.input_model)
    from .data_loader import load_file
    X, label, _ = load_file(config.data, config)
    booster.refit(X, label, params)
    booster.save_model(config.output_model)
    Log.info(f"Finished refitting; model saved to {config.output_model}")


def main() -> int:
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
