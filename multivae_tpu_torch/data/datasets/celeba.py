"""CelebA images with binary attributes (counterpart of
``multivae_tpu/data/datasets/celeba.py``).

Reads the standard layout under ``<root>/celeba``: the
``img_align_celeba/`` JPGs, ``list_attr_celeba.txt`` and
``list_eval_partition.txt``. Images are loaded per batch, resized so that
the short side is 64 (bilinear) and centre-cropped to (3, 64, 64) in
[0, 1]; the attributes are the 18-attribute subset or all 40, as {0, 1}.
The JPGs need Pillow, imported when an image is read.
"""

from __future__ import annotations

import os
from typing import Literal

import numpy as np

from ..utils import import_pil
from .base import DatasetOutput, MultimodalBaseDataset

ATTR_18 = [4, 5, 8, 9, 11, 12, 15, 17, 18, 20, 21, 22, 26, 28, 31, 32, 33, 35]

_SPLIT_CODE = {"train": 0, "valid": 1, "test": 2, "all": None}


def _default_transform(img):
    """Resize the short side to 64 (bilinear), centre-crop 64x64, RGB ->
    (3, 64, 64) float32 in [0, 1]."""
    Image = import_pil("Reading CelebA's JPG images")
    w, h = img.size
    scale = 64 / min(w, h)
    img = img.resize((max(64, int(round(w * scale))), max(64, int(round(h * scale)))),
                     Image.BILINEAR)
    w, h = img.size
    left, top = (w - 64) // 2, (h - 64) // 2
    img = img.crop((left, top, left + 64, top + 64)).convert("RGB")
    return np.transpose(np.asarray(img, np.float32) / 255.0, (2, 0, 1))


class CelebAttr(MultimodalBaseDataset):
    """CelebA images paired with binary attribute vectors (modalities
    ``image`` and ``attributes``; the labels are the attributes)."""

    def __init__(self, root: str, split: str, transform=None, target_transform=None,
                 attributes: Literal["18", "40"] = "18", download: bool = False):
        self.root = root
        self.transform = transform or _default_transform
        base = os.path.join(root, "celeba")
        attr_path = os.path.join(base, "list_attr_celeba.txt")
        part_path = os.path.join(base, "list_eval_partition.txt")
        self.img_dir = os.path.join(base, "img_align_celeba")
        for p in [attr_path, part_path, self.img_dir]:
            if not os.path.exists(p):
                raise AttributeError(
                    f"CelebA file/folder {p} not found. Place the standard CelebA "
                    "files under <root>/celeba.")

        with open(attr_path) as f:
            lines = f.read().strip().splitlines()
        self.attr_names = lines[1].split()
        entries = [ln.split() for ln in lines[2:]]
        filenames = np.array([e[0] for e in entries])
        attrs = np.array([[int(v) for v in e[1:]] for e in entries], np.int64)
        attrs = (attrs + 1) // 2   # {-1, 1} -> {0, 1}

        with open(part_path) as f:
            part = {ln.split()[0]: int(ln.split()[1]) for ln in f.read().strip().splitlines()}
        code = _SPLIT_CODE.get(split, 0)
        if code is None:
            keep = np.ones(len(filenames), bool)
        else:
            keep = np.array([part.get(fn, 0) == code for fn in filenames])

        self.filenames = filenames[keep]
        self.attributes_to_keep = ATTR_18 if attributes == "18" else list(range(40))
        self.attrs = attrs[keep][:, self.attributes_to_keep]
        self.attr_to_idx = {name: i for i, name in enumerate(self.attr_names)}
        self.idx_to_attr = {v: k for k, v in self.attr_to_idx.items()}

    def __len__(self):
        return len(self.filenames)

    def _load_image(self, filename):
        Image = import_pil("Reading CelebA's JPG images")
        with Image.open(os.path.join(self.img_dir, filename)) as img:
            return self.transform(img)

    def __getitem__(self, index):
        return DatasetOutput(
            data=dict(image=self._load_image(self.filenames[index]),
                      attributes=self.attrs[index].astype(np.float32)),
            labels=self.attrs[index])

    def get_batch(self, indices):
        images = np.stack([self._load_image(self.filenames[i]) for i in indices])
        return DatasetOutput(
            data=dict(image=images, attributes=self.attrs[indices].astype(np.float32)),
            labels=self.attrs[indices])

    @property
    def labels(self):
        return self.attrs

    @labels.setter
    def labels(self, value):
        pass
