"""Archive download and extraction for the bundled datasets (counterpart
of ``multivae_tpu/data/download.py``), on the standard library alone:
``urllib`` fetches, ``zipfile`` and ``tarfile`` extract. PolyMNIST comes
from zenodo and CUB from the authors' mirror; MHD's Google-Drive files
need the optional ``gdown`` (``datasets/mhd.py``).
"""

from __future__ import annotations

import hashlib
import logging
import os
import tarfile
import zipfile

logger = logging.getLogger(__name__)

DATASET_URLS = {
    "PolyMNIST": "https://zenodo.org/record/4899160/files/PolyMNIST.zip",
    "CUB": "http://www.robots.ox.ac.uk/~yshi/mmdgm/datasets/cub.zip",
}


def extract_archive(archive_path: str, dest_dir: str):
    """Extract a .zip or .tar(.gz) archive into ``dest_dir``."""
    if zipfile.is_zipfile(archive_path):
        with zipfile.ZipFile(archive_path) as zf:
            zf.extractall(dest_dir)
        return
    if tarfile.is_tarfile(archive_path):
        with tarfile.open(archive_path) as tf:
            # filter="data" refuses members that leave dest_dir, links out of
            # it and device files (the CUB mirror is plain http)
            tf.extractall(dest_dir, filter="data")
        return
    raise ValueError(f"Unsupported archive format: {archive_path}")


def sha256_of(path: str, chunk: int = 1 << 20) -> str:
    """The hex SHA-256 digest of a file, read in chunks."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def fetch_and_extract(url: str, dest_dir: str, archive_name: str = None,
                      keep_archive: bool = False, sha256: str = None) -> str:
    """Download an archive into ``dest_dir`` (unless it is there already)
    and extract it there; returns ``dest_dir``.

    A failed download raises RuntimeError naming the URL to fetch by hand.
    With ``sha256`` the archive is checked first: a mismatching file is
    deleted and the error names both digests. The archive is deleted after
    extraction unless ``keep_archive``.
    """
    import urllib.request

    os.makedirs(dest_dir, exist_ok=True)
    archive_name = archive_name or os.path.basename(url.split("?")[0])
    archive_path = os.path.join(dest_dir, archive_name)
    if not os.path.exists(archive_path):
        logger.info("Downloading %s -> %s", url, archive_path)
        try:
            urllib.request.urlretrieve(url, archive_path)
        except Exception as e:  # noqa: BLE001 - surface the manual fallback
            raise RuntimeError(
                f"Download failed ({e}). Download manually from {url} and "
                f"extract into {dest_dir}.") from e
    if sha256 is not None:
        digest = sha256_of(archive_path)
        if digest != sha256.lower():
            os.remove(archive_path)
            raise RuntimeError(
                f"Checksum mismatch for {archive_path}: expected {sha256}, "
                f"got {digest}. The corrupt file was deleted; retry the "
                "download.")
    logger.info("Extracting %s", archive_path)
    extract_archive(archive_path, dest_dir)
    if not keep_archive:
        os.remove(archive_path)
    return dest_dir


def maybe_download_mmnist(data_path: str):
    """Fetch PolyMNIST (zenodo) into ``data_path`` (creates MMNIST/...)."""
    return fetch_and_extract(DATASET_URLS["PolyMNIST"], data_path,
                             archive_name="PolyMNIST.zip")


def maybe_download_cub(data_path: str):
    """Fetch CUB's images and captions into ``data_path`` (creates cub/...)."""
    return fetch_and_extract(DATASET_URLS["CUB"], data_path, archive_name="cub.zip")
