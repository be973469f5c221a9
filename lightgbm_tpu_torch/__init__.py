"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

``import lightgbm_tpu_torch as lgb`` gives ``lgb.Dataset``,
``lgb.train``, ``lgb.cv``, ``lgb.Booster``, ``lgb.Config``, the
training callbacks, the sklearn estimators (``LGBMClassifier``, ...)
and the plotting helpers; ``python -m lightgbm_tpu_torch
config=train.conf`` is the command line (``cli.py``) and
``lightgbm_tpu_torch.capi`` the flat ``LGBM_*`` surface.  Training and
prediction run on the CUDA device unless ``device="cpu"`` is passed in
params; the device kernels are hand-written CUDA (``csrc/``), built for
Hopper (sm_90a) at first use.  The package imports neither jax nor
lightgbm_tpu.
"""
from . import callback, plotting
from .basic import Dataset
from .booster import Booster
from .callback import (early_stopping, print_evaluation, record_evaluation,
                       reset_parameter)
from .config import Config
from .engine import CVBooster, EarlyStopException, cv, train
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_tree)
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .utils.log import LightGBMError, Log

__version__ = "0.1.0"

__all__ = ["Dataset", "Booster", "Config", "train", "cv", "CVBooster",
           "EarlyStopException", "Log", "LightGBMError", "callback",
           "early_stopping", "print_evaluation", "record_evaluation",
           "reset_parameter", "LGBMModel", "LGBMRegressor",
           "LGBMClassifier", "LGBMRanker", "plotting", "plot_importance",
           "plot_metric", "plot_tree", "create_tree_digraph",
           "__version__"]
