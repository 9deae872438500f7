"""FID evaluator config (counterpart of
``multivae_tpu/metrics/fids/fids_config.py``, without its TPU-only
``fused_sweep``, ``subset_chunk`` and ``subset_activation_budget_gb``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..base.evaluator_config import EvaluatorConfig


@dataclasses.dataclass
class FIDEvaluatorConfig(EvaluatorConfig):
    """Config for the Fréchet-distance evaluation.

    Args:
        inception_weights_path: path of pytorch-fid's InceptionV3 state
            dict. Required only when no custom encoders are provided.
        dims_inception: embedding dimension of the inception layer (2048).
    """

    inception_weights_path: Optional[str] = "../fid_model/pt_inception-2015-12-05.pth"
    dims_inception: int = 2048
