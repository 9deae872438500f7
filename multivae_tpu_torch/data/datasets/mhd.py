"""MHD (Multimodal Handwritten Digits) with Missing-Not-At-Random
modalities (counterpart of ``multivae_tpu/data/datasets/mhd.py``).

Modalities image (1, 28, 28), label (10,) one-hot, trajectory (200,) and
audio, read from the ``mhd_<split>.pt`` tuple; the audio spectrogram is
stored stacked (3, 32, 32) and unstacked once at load to (1, 32, 96).
Per-class missing probabilities give an incomplete dataset: modality i's
mask comes from ``default_rng(seed + i)``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .base import IncompleteDataset, MultimodalBaseDataset

_URLS = {   # Google-Drive-hosted files
    "train": "https://docs.google.com/uc?export=download&id=1Tj1i-hXA0INQpU0jmuTMO4IwfDoGD2oV",
    "test": "https://docs.google.com/uc?export=download&id=1qiEjFNCFn1ws383pKmY3zJtm4JDymOU6",
}


def unstack_audio(audio: np.ndarray) -> np.ndarray:
    """(N, 3, 32, 32) stacked spectrogram -> (N, 1, 32, 96)."""
    n = audio.shape[0]
    un = audio.reshape(n, 3 * audio.shape[2], audio.shape[3])   # (N, 96, 32)
    return np.transpose(un[:, None], (0, 1, 3, 2))


class MHD(IncompleteDataset):
    """Multimodal Handwritten Digits.

    Args:
        datapath: folder holding ``mhd_<split>.pt``.
        split: 'train' or 'test'.
        modalities: subset of ['label', 'audio', 'trajectory', 'image'].
        download: fetch the file with the optional ``gdown`` when absent.
        missing_probabilities: modality -> 10 per-class missing probabilities.
        seed: seed of the masks.
    """

    def __init__(self, datapath: str, split: str = "train",
                 modalities=("label", "audio", "trajectory", "image"),
                 download: bool = False, missing_probabilities=None, seed: int = 0):
        self.data_file = os.path.join(datapath, f"mhd_{split}.pt")
        self.modalities = list(modalities)
        if missing_probabilities is None:
            missing_probabilities = {m: [0.0] * 10 for m in self.modalities}
        if not os.path.exists(self.data_file):
            if download:
                try:
                    import gdown
                except ImportError as e:
                    raise RuntimeError(
                        "Downloading MHD requires the optional gdown package "
                        f"(`pip install gdown`), or fetch {_URLS[split]} manually "
                        f"to {self.data_file}.") from e
                os.makedirs(datapath, exist_ok=True)
                gdown.download(_URLS[split], self.data_file, quiet=False)
            if not os.path.exists(self.data_file):
                raise RuntimeError(
                    f"Dataset not found at path {datapath}. Pass download=True "
                    f"(requires gdown) or fetch {_URLS[split]} manually.")
        # the tuple holds two normalization objects besides the tensors
        (s_data, i_data, t_data, a_data, traj_norm, audio_norm) = torch.load(
            self.data_file, weights_only=False)
        s_data = np.asarray(s_data)
        self._traj_normalization = traj_norm
        self._audio_normalization = audio_norm

        data = {}
        if "image" in self.modalities:
            data["image"] = np.asarray(i_data, np.float32)
        if "label" in self.modalities:
            data["label"] = np.eye(10, dtype=np.float32)[s_data]
        if "trajectory" in self.modalities:
            data["trajectory"] = np.asarray(t_data, np.float32)
        if "audio" in self.modalities:
            data["audio"] = unstack_audio(np.asarray(a_data, np.float32))

        labels = s_data.astype(np.int64)
        self.is_incomplete = sum(sum(p) for p in missing_probabilities.values()) != 0
        if self.is_incomplete:
            masks = {}
            for i, mod in enumerate(data):
                p_missing = np.asarray(missing_probabilities[mod])[labels]
                masks[mod] = np.random.default_rng(seed + i).binomial(
                    1, 1 - p_missing).astype(bool)
            for k in masks:
                data[k] = data[k] * masks[k].reshape(
                    -1, *([1] * (data[k].ndim - 1))).astype(np.float32)
            super().__init__(data=data, masks=masks, labels=labels)
        else:
            self.masks = None
            MultimodalBaseDataset.__init__(self, data=data, labels=labels)

    def _check_lengths(self):
        if self.masks:
            return IncompleteDataset._check_lengths(self)
        return MultimodalBaseDataset._check_lengths(self)

    def get_batch(self, indices):
        if self.is_incomplete:
            return IncompleteDataset.get_batch(self, indices)
        return MultimodalBaseDataset.get_batch(self, indices)

    def get_audio_normalization(self):
        return self._audio_normalization

    def get_traj_normalization(self):
        return self._traj_normalization
