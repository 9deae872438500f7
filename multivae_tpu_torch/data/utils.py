"""Image-grid helpers of the evaluators (counterpart of
``multivae_tpu/data/utils.py``): ``adapt_shape`` and ``make_grid`` as
there, ``grid_to_image`` giving the uint8 pixels that the JAX package's
``grid_to_pil`` puts in a PIL image, and ``write_png``, a PNG writer on the
standard library's ``zlib`` and ``struct``, so that no image package is
needed.
"""

from __future__ import annotations

import struct
import zlib
from math import ceil, floor
from typing import Dict

import numpy as np


def adapt_shape(data: Dict[str, np.ndarray]):
    """Pad or expand every modality to (n, 3, h, w) with a common h, w:
    vectors and (n, h, w) maps gain axes, one channel is tiled to three, two
    get a zero third, more are cut to three; smaller maps are zero-padded
    around the centre. Returns (data, (3, h, w))."""
    out = {}
    for m in data:
        x = np.asarray(data[m])
        if x.ndim == 1:
            x = x[:, None]
        if x.ndim == 2:
            x = x[:, None]
        if x.ndim == 3:
            x = x[:, None]
        if x.ndim != 4:
            raise AttributeError("Can't visualize data with more than 3 dimensions")
        if x.shape[1] == 1:
            x = np.concatenate([x] * 3, axis=1)
        elif x.shape[1] == 2:
            n, _, h, w = x.shape
            x = np.concatenate([x, np.zeros((n, 1, h, w), x.dtype)], axis=1)
        else:
            x = x[:, :3]
        out[m] = x

    h = max(out[m].shape[2] for m in out)
    w = max(out[m].shape[3] for m in out)
    for m in out:
        hm, wm = out[m].shape[2:]
        out[m] = np.pad(out[m], ((0, 0), (0, 0),
                                 (floor((h - hm) / 2), ceil((h - hm) / 2)),
                                 (floor((w - wm) / 2), ceil((w - wm) / 2))),
                        mode="constant")
    return out, (3, h, w)


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """Arrange (N, C, H, W) images into a (C, H', W') grid of ``nrow``
    columns (torchvision's ``make_grid`` layout)."""
    images = np.asarray(images)
    n, c, h, w = images.shape
    ncols = min(nrow, n)
    nrows = int(ceil(n / ncols))
    grid = np.full((c, padding + nrows * (h + padding), padding + ncols * (w + padding)),
                   pad_value, dtype=images.dtype)
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[:, y:y + h, x:x + w] = images[idx]
    return grid


def grid_to_image(grid: np.ndarray) -> np.ndarray:
    """(C, H, W) float grid in [0, 1] -> (H, W, C) uint8 pixels, rounded
    half up and clipped."""
    arr = np.clip(np.asarray(grid) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.transpose(arr, (1, 2, 0)))


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray):
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (no filtering,
    one IDAT chunk)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {image.dtype} "
                         f"{image.shape}")
    h, w, _ = image.shape
    # each scanline starts with its filter type, 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))
