"""Boosting modes (reference src/boosting/boosting.cpp:30-64)."""
from __future__ import annotations

from ..config import Config
from ..dataset import Dataset
from ..utils.log import Log
from .gbdt import GBDT


def create_boosting(config: Config, train_set: Dataset,
                    custom_objective: bool = False) -> GBDT:
    """The trainer of ``boosting_type``: gbdt, dart, goss or rf
    (lightgbm_tpu/boosting/__init__.py)."""
    bt = config.boosting_type
    if bt == "gbdt":
        return GBDT(config, train_set, custom_objective=custom_objective)
    if bt == "dart":
        from .dart import DART
        return DART(config, train_set, custom_objective=custom_objective)
    if bt == "goss":
        from .goss import GOSS
        return GOSS(config, train_set, custom_objective=custom_objective)
    if bt == "rf":
        from .rf import RF
        return RF(config, train_set, custom_objective=custom_objective)
    Log.fatal(f"Unknown boosting type {bt}")


__all__ = ["GBDT", "create_boosting"]
