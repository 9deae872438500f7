"""Trainer utilities (counterpart of ``multivae_tpu/trainers/base/utils.py``)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int):
    """Seed python's, numpy's and torch's global generators. The trainer's
    own draws come from its ``torch.Generator``, seeded apart."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def update_dict(dict1: dict, dict2: dict):
    """In place, add the values of ``dict2`` into ``dict1``."""
    for k in dict2:
        if k in dict1:
            dict1[k] = dict1[k] + dict2[k]
        else:
            dict1[k] = dict2[k]
    return dict1
