"""Command-line application: train / predict / convert_model / refit /
serve (port of lightgbm_tpu/cli.py).

The analog of the reference CLI driver (reference: src/main.cpp,
src/application/application.cpp:30-268 — param parsing with config
file + k=v args, task dispatch, data loading, prediction output file).
Training and prediction run on the CUDA device unless ``device=cpu``
is given; without a CUDA device the run raises.  ``num_machines > 1``
with ``machines=``/``machine_list_file=`` goes through the
call-compatible ``LGBM_NetworkInit`` (which warns), as in the JAX CLI;
multi-process training is ``parallel.distributed.initialize`` with
``collective_transport=tcp`` or ``xla`` (torch.distributed).

Usage:  python -m lightgbm_tpu_torch config=train.conf [key=value ...]
"""
from __future__ import annotations

import os
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
    if task == "train":
        _task_train(params, config)
    elif task in ("predict", "prediction", "test"):
        _task_predict(params, config)
    elif task == "convert_model":
        _task_convert(params, config)
    elif task == "refit":
        _task_refit(params, config)
    elif task == "serve":
        _task_serve(params, config)
    else:
        Log.fatal(f"Unknown task {task}")
    from .telemetry import TELEMETRY
    if TELEMETRY.on and config.telemetry_out:
        # the export at the task's end (the atexit hook is the safety
        # net): <telemetry_out>.jsonl and <telemetry_out>.perfetto.json
        paths = TELEMETRY.export(config.telemetry_out)
        Log.info("telemetry written: " + ", ".join(paths))
    if TELEMETRY.on and config.telemetry_prom_out:
        # the Prometheus text file (a node-exporter textfile collector
        # reads it)
        Log.info("prometheus metrics written: "
                 + TELEMETRY.write_prom(config.telemetry_prom_out))
    return 0


def _task_train(params, config: Config) -> None:
    if not config.data:
        Log.fatal("No training data: set data=<file>")
    if config.num_machines > 1:
        # socket rendezvous config (reference application.cpp:87-105;
        # JAX cli.py:84-115): machines= inline list wins,
        # machine_list_file= is the file form; forwarded to the
        # call-compat network surface
        machines = config.machines
        if not machines and config.machine_list_file:
            if not os.path.exists(config.machine_list_file):
                Log.fatal("machine_list_file not found: "
                          f"{config.machine_list_file}")
            with open(config.machine_list_file) as f:
                machines = ",".join(ln.strip() for ln in f if ln.strip())
        if machines:
            from .capi import LGBM_NetworkInit
            from .reliability.faults import FAULTS
            from .reliability.retry import RetryPolicy, retry_call

            def _net_init():
                FAULTS.fault_point("distributed.init")
                return LGBM_NetworkInit(machines, config.local_listen_port,
                                        config.time_out,
                                        config.num_machines)
            # transient rendezvous failures retry with growing backoff
            # for the reference's time_out budget (minutes)
            policy = RetryPolicy.from_config(config)
            policy.budget_s = config.time_out * 60.0
            retry_call(_net_init, seam="distributed.init", policy=policy)
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


def _task_serve(params, config: Config) -> None:
    """Online serving: publish input_model into a registry (warming its
    buckets on the card first: predict_warm_buckets, or the ladder from
    predict_min_bucket_rows up to serve_max_batch_rows), then serve
    POST /predict/<model> with micro-batching and load shedding from
    the shared /metrics + /healthz listener until SIGTERM or SIGINT,
    which stop admission, drain the queues and return (exit code 0).

    With ``continuous_ingest_dir`` set, the continuous-training lane
    runs BESIDE the frontend: new data slices dropped into the directory
    are append-constructed against the base dataset (``data=``), trained
    from the last good model (``continuous_mode=continue|refit``),
    eval-gated and hot-published into the SAME registry this frontend
    serves from — GET/POST /continuous on the shared listener.  SIGTERM
    lets the lane finish its cycle (every phase ends in a ledger
    commit), then drains and returns."""
    if not config.input_model:
        Log.fatal("No model file: set input_model=<file>")
    if config.continuous_ingest_dir and not config.data:
        Log.fatal("continuous_ingest_dir is set but data= is not: the "
                  "lane needs the base dataset whose bin mappers "
                  "ingested slices bind to")
    import os
    import signal
    import threading

    from .serving import ModelRegistry, ServingFrontend
    resolve_device(config)
    # graceful SIGTERM drain: the orchestrator's polite shutdown must
    # not look like a crash.  Installed BEFORE the first publish so a
    # shutdown during warm-up is graceful too
    stop = threading.Event()

    def _on_sigterm(signum, frame):
        Log.info("SIGTERM: stopping admission and draining in-flight "
                 "work (serving queues + continuous lane)")
        stop.set()

    prev_term = signal.signal(signal.SIGTERM, _on_sigterm)
    name = os.path.splitext(
        os.path.basename(config.input_model))[0] or "model"
    registry = ModelRegistry(config)
    frontend = ServingFrontend(registry, config)
    lane = None
    try:
        entry = registry.publish(name, config.input_model, log_warm=True)
        srv = frontend.start()
        port = srv.server_address[1]
        Log.info(f"serving model {name!r} at "
                 f"http://127.0.0.1:{port}/predict/{name} "
                 '(POST JSON {"rows": [[...]]} or CSV rows, or binary '
                 "application/x-ltpu-f32; GET /models /metrics /healthz)")
        if registry.pool is not None:
            Log.info(f"lane fleet: {registry.pool.n_lanes} dispatch "
                     f"lanes (serve_lanes={config.serve_lanes}); per-lane "
                     "state on GET /models under '_fleet'")
        if entry.monitor is not None:
            # drift monitors armed from the <input_model>.quality.json
            # sidecar a quality=on training run saved beside the model
            Log.info(f"quality monitors armed for {name!r}: sample "
                     f"stride {entry.monitor.stride}, drift report at "
                     f"http://127.0.0.1:{port}/quality/{name} "
                     f"(ltpu_quality_* gauges on /metrics)")
        if config.continuous_ingest_dir:
            from .continuous import ContinuousLane
            lane = ContinuousLane(config, registry, name=name,
                                  train_params=dict(params)).start()
            Log.info(f"continuous-training lane armed: watching "
                     f"{config.continuous_ingest_dir} "
                     f"(mode={config.continuous_mode}, poll "
                     f"{config.continuous_poll_s:g}s; GET/POST "
                     f"http://127.0.0.1:{port}/continuous)")
        stop.wait()                   # serve until SIGTERM or SIGINT
    except KeyboardInterrupt:
        Log.info("interrupt: draining serving queues")
    finally:
        if prev_term is not None:
            # None = the previous disposition was installed outside
            # Python (embedding host); signal.signal(None) would raise
            signal.signal(signal.SIGTERM, prev_term)
        if lane is not None:
            lane.stop()
        frontend.stop(drain=True)
    Log.info("serving drained cleanly; exiting 0")


def main() -> int:
    return run(sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
