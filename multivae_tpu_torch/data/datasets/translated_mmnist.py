"""Translated PolyMNIST: MNIST digits, shrunk and placed at random, inverted
on crops of background images (counterpart of
``multivae_tpu/data/datasets/translated_mmnist.py``).

Generation follows the JAX package draw for draw from ``default_rng(seed)``
and writes ``m{i}/{idx}.{digit}.png`` under
``Translated_MMNIST_scale_<100 scale>_translated_<translate>/<split>``. It
needs Pillow, imported there alone, to open the background images and to
write the PNGs as the JAX package does. The digit is shrunk by a bilinear
resize with antialiasing (``jax.image.resize(..., "bilinear")`` shrinks
so), here ``F.interpolate(..., antialias=True)``; the two agree to float32
rounding, so a pixel of the binarized digit (``> 128``) can differ where the
resized value lies within an ulp of 128. Reading the cached PNGs needs no
image package (``data/utils.read_png``).
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import import_pil, png_to_chw
from .base import DatasetOutput, MultimodalBaseDataset
from .mnist_svhn import load_mnist

logger = logging.getLogger(__name__)


def shrink_digit(image: np.ndarray, size: int) -> np.ndarray:
    """A (28, 28) float32 digit resized to (size, size), bilinear with
    antialiasing."""
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))[None, None]
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)[0, 0].numpy()


class TranslatedMMNIST(MultimodalBaseDataset):
    """Translated PolyMNIST built from background images.

    Args:
        path: parent folder of the generated dataset (MNIST's raw files
            under it, see ``load_mnist``).
        scale: digit downscale factor.
        translate: place the shrunk digit at random.
        n_modalities: number of modalities (background images used).
        background_path: folder of background .jpg/.png images; needed only
            when the dataset is not generated yet.
        split: 'train' or 'test'.
        seed: seed of the generation.
    """

    def __init__(self, path: str, scale: float, translate: bool, n_modalities: int,
                 background_path: str = None, split: str = "train", transform=None,
                 target_transform=None, seed: int = 0):
        self.scale = scale
        self.translate = translate
        self.parent_path = path
        self.num_modalities = n_modalities
        self.save_path = os.path.join(
            path, f"Translated_MMNIST_scale_{int(scale * 100)}_translated_{translate}",
            split)
        self._rng = np.random.default_rng(seed)

        unimodal_paths = [os.path.join(self.save_path, f"m{i}") for i in range(n_modalities)]
        self.check_or_create_dataset(unimodal_paths, background_path, split)

        self.file_paths = {}
        num_files = None
        for dp in unimodal_paths:
            files = sorted(glob.glob(os.path.join(dp, "*.png")))
            self.file_paths[dp] = files
            if num_files is None:
                num_files = len(files)
            if len(files) != num_files:
                raise AssertionError("each modality must have the same number of images")
        self.num_files = num_files

    def check_or_create_dataset(self, unimodal_paths, background_path, split):
        """Generate the dataset from ``background_path`` unless every
        modality's folder exists."""
        if all(os.path.exists(p) for p in unimodal_paths):
            return
        if background_path is None:
            raise ValueError(
                "The provided path does not contain the dataset in the proper "
                "format and no background path was provided.")
        if not os.path.exists(background_path):
            raise ValueError(f"Provided path {background_path} doesn't exist")
        logger.info("Dataset not found, creating dataset from the background path.")
        self._create_mmnist_dataset(background_path, split == "train")

    def _create_mmnist_dataset(self, background_path, train: bool):
        Image = import_pil("Generating TranslatedMMNIST from background images")
        images, targets = load_mnist(self.parent_path, train=train)
        background_filepaths = sorted(glob.glob(os.path.join(background_path, "*.jpg"))
                                      + glob.glob(os.path.join(background_path, "*.png")))
        if self.num_modalities > len(background_filepaths):
            raise ValueError("Number of background images must be larger or equal to "
                             "number of modalities")
        backgrounds = [Image.open(fp).convert("RGB") for fp in background_filepaths]
        for m in range(self.num_modalities):
            os.makedirs(os.path.join(self.save_path, f"m{m}"), exist_ok=True)

        cnt = 0
        for digit in range(10):
            ixs = np.nonzero(targets == digit)[0]
            for m in range(self.num_modalities):
                ixs_perm = ixs[self._rng.permutation(len(ixs))]
                for i, ix in enumerate(ixs_perm):
                    new_img = self._add_background_image(backgrounds[m], images[ix])
                    out = (np.clip(new_img, 0, 1) * 255).astype(np.uint8)
                    Image.fromarray(np.transpose(out, (1, 2, 0))).save(
                        os.path.join(self.save_path, f"m{m}/{i}.{digit}.png"))
                    cnt += 1
        logger.info("Saved %d images to %s", cnt, self.save_path)

    def _add_background_image(self, background_pil, mnist_image,
                              change_colors: bool = False):
        """The digit (shrunk and placed when ``translate``) binarized at 128,
        inverting a random 28x28 crop of the background where it is set."""
        mnist_image = np.asarray(mnist_image, np.float32)
        if self.translate:
            small = int(28 * self.scale)
            down = shrink_digit(mnist_image, small)
            canvas = np.zeros_like(mnist_image)
            x = self._rng.integers(0, int(28 * (1 - self.scale)))
            y = self._rng.integers(0, int(28 * (1 - self.scale)))
            canvas[x:x + small, y:y + small] = down
            mnist_image = canvas

        binarized = mnist_image > 128

        x_c = self._rng.integers(0, background_pil.size[0] - 28)
        y_c = self._rng.integers(0, background_pil.size[1] - 28)
        crop = background_pil.crop((x_c, y_c, x_c + 28, y_c + 28))
        new_img = np.transpose(np.asarray(crop, np.float32) / 255.0, (2, 0, 1))
        if change_colors:
            for j in range(3):
                new_img[:, :, j] = (new_img[:, :, j] + self._rng.uniform(0, 1)) / 2.0
        new_img[:, binarized] = 1.0 - new_img[:, binarized]
        return new_img

    def __len__(self):
        return self.num_files

    def _row(self, idx: int):
        files = [self.file_paths[dp][idx] for dp in self.file_paths]
        images = {f"m{m}": png_to_chw(files[m]) for m in range(self.num_modalities)}
        return images, int(os.path.basename(files[0]).split(".")[-2])

    def __getitem__(self, index):
        images, label = self._row(int(index))
        return DatasetOutput(data=images, labels=label)

    def get_batch(self, indices):
        rows = [self._row(int(idx)) for idx in indices]
        return DatasetOutput(
            data={f"m{m}": np.stack([r[0][f"m{m}"] for r in rows])
                  for m in range(self.num_modalities)},
            labels=np.asarray([r[1] for r in rows]))
