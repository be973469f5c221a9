"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

``import lightgbm_tpu_torch as lgb`` gives ``lgb.Dataset``,
``lgb.train``, ``lgb.cv``, ``lgb.Booster``, ``lgb.Config`` and the
training callbacks.  Training and prediction run on the CUDA device
unless ``device="cpu"`` is passed in params; the device kernels are
hand-written CUDA (``csrc/``), built for Hopper (sm_90a) at first use.
The package imports neither jax nor lightgbm_tpu.
"""
from . import callback
from .basic import Dataset
from .booster import Booster
from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, EarlyStopException, cv, train

__all__ = ["Dataset", "Booster", "Config", "train", "cv", "CVBooster",
           "EarlyStopException", "callback", "early_stopping",
           "print_evaluation", "record_evaluation", "reset_parameter"]
__version__ = "0.1.0"
