"""PolyMNIST digit classifier and its pretrained-checkpoint loader
(counterpart of ``multivae_tpu/metrics/classifiers/mmnist.py``).

The module keeps the reference's torch layout, ``encoder`` a Sequential
whose convs and Linears are ``encoder.0``, ``.3``, ``.7`` and ``.10`` with
dropout between them, so that the reference's checkpoints load as they are
and the JAX package's ``convert_torch_classifier_state_dict`` maps this
module's ``state_dict`` to its Flax classifier. The checkpoints are read as
torch state dicts; the JAX package's msgpack form needs Flax and is not
read here.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
from torch import nn


class ClassifierPolyMNIST(nn.Module):
    """(B, 3, 28, 28) -> (B, 10) digit logits. Built in eval mode (the
    dropout layers off), as every evaluator uses it."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.Sequential(
            nn.Conv2d(3, 10, kernel_size=4, stride=2, padding=1),
            nn.Dropout2d(0.5),
            nn.ReLU(),
            nn.Conv2d(10, 20, kernel_size=4, stride=2, padding=1),
            nn.Dropout2d(0.5),
            nn.ReLU(),
            nn.Flatten(),
            nn.Linear(980, 128),
            nn.Dropout(0.5),
            nn.ReLU(),
            nn.Linear(128, 10),
        )
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        with ``generator``."""
        for layer in self.encoder:
            if isinstance(layer, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(layer.weight[0].numel())
                with torch.no_grad():
                    for p in (layer.weight, layer.bias):
                        p.uniform_(-bound, bound, generator=generator)
        return self

    def features(self, x) -> torch.Tensor:
        """The 128 ReLU features before the last layer, (B, 128)."""
        return self.encoder[:10](x)

    def forward(self, x) -> torch.Tensor:
        return self.encoder(x)


def load_mmnist_classifiers(data_path: str = ".data/clf", device="cuda") -> dict:
    """The five pretrained PolyMNIST classifiers ``{"m0": ..., "m4": ...}``
    from the reference's torch checkpoints
    ``<data_path>/pretrained_img_to_digit_clf_m{i}``, on ``device``."""
    from ...utils.device import resolve_device

    device = resolve_device(device)
    clfs = {}
    for i in range(5):
        path = os.path.join(data_path, f"pretrained_img_to_digit_clf_m{i}")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"No classifier checkpoint found for modality m{i} under {data_path} "
                f"(expected the torch state dict {path}).")
        state = torch.load(path, map_location="cpu", weights_only=True)
        clf = ClassifierPolyMNIST()
        clf.load_state_dict(state)
        clfs[f"m{i}"] = clf.to(device).eval()
    return clfs
