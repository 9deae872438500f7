"""Batch and image helpers (counterpart of ``multivae_tpu/data/utils.py``):
``get_batch_size``, ``drop_unused_modalities``, ``adapt_shape`` and
``make_grid`` as there, ``grid_to_image`` giving the uint8 pixels that the
JAX package's ``grid_to_pil`` puts in a PIL image, and ``write_png`` and
``read_png``, a PNG writer and reader on the standard library's ``zlib``
and ``struct``, so that no image package is needed.
"""

from __future__ import annotations

import struct
import zlib
from math import ceil, floor
from typing import Dict

import numpy as np

from .batch import MultimodalBatch, first_leaf


def import_pil(purpose: str):
    """``PIL.Image``, imported on demand, or an ImportError naming what
    needs it (the port's own paths read and write PNGs without it)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{purpose} needs Pillow (`pip install pillow`).") from e
    return Image


def get_batch_size(inputs) -> int:
    """Rows of a batch, dataset output or dict with ``data`` (the first
    modality's, the first array of a nested one)."""
    if isinstance(inputs, MultimodalBatch):
        return inputs.n_samples
    data = inputs["data"] if isinstance(inputs, dict) else inputs.data
    return len(first_leaf(next(iter(data.values()))))


def drop_unused_modalities(inputs):
    """Drop, in place, the modalities that no row of the batch has (all of
    their mask false); inputs without masks are returned as they are."""
    masks = getattr(inputs, "masks", None)
    if masks is None and isinstance(inputs, dict):
        masks = inputs.get("masks", None)
    if masks is None:
        return inputs
    data = inputs["data"] if isinstance(inputs, dict) else inputs.data
    for m in list(masks.keys()):
        if not np.any(np.asarray(masks[m])):
            data.pop(m)
            masks.pop(m)
    return inputs


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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> channels


def _paeth_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = np.empty(len(line), np.int64)
    for i in range(len(line)):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (line[i] + pred) & 0xFF
    return out


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (none, sub, up, average, Paeth)."""
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:   # sub: a running sum along the row, per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind == 3:
            cur = np.empty(stride, np.int64)
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif kind == 4:
            cur = _paeth_row(line, prev, bpp)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced grey, grey+alpha, RGB or RGBA PNG as an
    (H, W, C) uint8 array (C the file's channels)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        kind, payload = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"IEND":
            break
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey/RGB(A) PNGs are "
                         f"read (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    channels = _PNG_CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)


def png_to_chw(path: str) -> np.ndarray:
    """A PNG as a (3, H, W) float32 array in [0, 1], converted to RGB as
    PIL's ``convert("RGB")`` does (grey tiled, alpha dropped)."""
    arr = read_png(path)
    arr = arr[..., :1].repeat(3, -1) if arr.shape[-1] < 3 else arr[..., :3]
    return np.transpose(arr.astype(np.float32) / 255.0, (2, 0, 1))
