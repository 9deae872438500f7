"""The port's datasets, their file readers and the data helpers against the
JAX package's, on files written here in the real formats (PolyMNIST's
``.npy`` / ``.pt``, MNIST's idx, SVHN's ``.mat``, MHD's ``.pt`` tuple,
CelebA's JPGs and lists, CUB's captions and images, Translated PolyMNIST's
PNG tree, zip and tar archives).

Both packages read the same files, or each its own copy of them where a
dataset writes caches (MnistSvhn's pairing, CUB's vocabulary and captions,
TranslatedMMNIST's generated PNGs), which are then held byte for byte.
Arrays, masks, labels, lengths and ``get_batch`` outputs are exact.
"""

import os
import shutil
import struct
import subprocess
import sys
import tarfile
import urllib.request
import zipfile
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multivae_tpu.data import DataLoader as JDataLoader
from multivae_tpu.data import IncompleteDataset as JIncompleteDataset
from multivae_tpu.data import MultimodalBaseDataset as JDataset
from multivae_tpu.data import download as jdownload
from multivae_tpu.data import utils as jutils
from multivae_tpu.data.batch import batch_from_arrays as j_batch_from_arrays
from multivae_tpu.data.datasets import (
    CUB as JCUB,
    MHD as JMHD,
    CelebAttr as JCelebAttr,
    MMNISTDataset as JMMNISTDataset,
    MnistLabels as JMnistLabels,
    MnistSvhn as JMnistSvhn,
    TranslatedMMNIST as JTranslatedMMNIST,
)
from multivae_tpu.data.datasets.cub import CUBSentences as JCUBSentences
from multivae_tpu.data.datasets.mnist_svhn import load_mnist as j_load_mnist
from multivae_tpu_torch.data import (
    DataLoader,
    IncompleteDataset,
    MultimodalBaseDataset,
    batch_from_arrays,
)
from multivae_tpu_torch.data import download, utils
from multivae_tpu_torch.data.datasets import (
    CUB,
    MHD,
    CelebAttr,
    CUBSentences,
    MMNISTDataset,
    MnistLabels,
    MnistSvhn,
    TranslatedMMNIST,
)
from multivae_tpu_torch.data.datasets.mnist_svhn import load_mnist
from multivae_tpu_torch.data.datasets.translated_mmnist import shrink_digit
from multivae_tpu_torch.tools import dataset_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MNIST = 40


def _assert_tree_equal(ours, ref, where=""):
    """Nested dicts of arrays (or scalars), equal in keys, dtype kind and
    values."""
    if isinstance(ref, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(ref), where
        ours, ref = dict(enumerate(ours)), dict(enumerate(ref))
    if isinstance(ref, dict):
        assert set(ours) == set(ref), where
        for k in ref:
            _assert_tree_equal(ours[k], ref[k], f"{where}/{k}")
        return
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype.kind == ref.dtype.kind, where
    np.testing.assert_array_equal(ours, ref, err_msg=where)


def _assert_same_dataset(ours, ref, rows=(0, 3, 1, 7)):
    assert len(ours) == len(ref)
    rows = np.asarray([r for r in rows if r < len(ref)])
    _assert_tree_equal(dict(ours.get_batch(rows)), dict(ref.get_batch(rows)))
    _assert_tree_equal(dict(ours[int(rows[0])]), dict(ref[int(rows[0])]))
    if getattr(ref, "labels", None) is not None:
        _assert_tree_equal(ours.labels, ref.labels, "labels")
    if getattr(ref, "masks", None) is not None:
        _assert_tree_equal(ours.masks, ref.masks, "masks")


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


# ------------------------------------------------------------------ PolyMNIST
@pytest.mark.parametrize("pt", [(), ("m0", "m3", "labels")])
@pytest.mark.parametrize("missing_ratio,keep", [(0.0, True), (0.4, True), (0.4, False)])
def test_polymnist_matches_jax(tmp_path, pt, missing_ratio, keep):
    """``.npy`` and ``.pt`` files; complete, MAR-incomplete (m0 always kept,
    zeroed rows) and cut to ``ceil(0.6 ** 4 * 20)`` complete rows."""
    root = dataset_files.write_polymnist(str(tmp_path), "train", 20, seed=2, pt=pt)
    kw = dict(split="train", missing_ratio=missing_ratio, keep_incomplete=keep)
    ours, ref = MMNISTDataset(root, **kw), JMMNISTDataset(root, **kw)
    assert len(ours) == {(0.0, True): 20, (0.4, True): 20, (0.4, False): 3}[(missing_ratio, keep)]
    _assert_same_dataset(ours, ref)
    _assert_tree_equal(ours.data, ref.data)
    assert ("masks" in ours.get_batch(np.arange(2))) == (missing_ratio > 0 and keep)
    if missing_ratio and keep:
        assert ours.masks["m0"].all() and not ours.masks["m1"].all()
        assert not ours.data["m1"][~ours.masks["m1"]].any()


def _polymnist_zip(tmp_path):
    dataset_files.write_polymnist(str(tmp_path / "src"), "train", 4, seed=1)
    archive = tmp_path / "PolyMNIST.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        for name in sorted(os.listdir(tmp_path / "src" / "MMNIST" / "train")):
            zf.write(tmp_path / "src" / "MMNIST" / "train" / name, f"MMNIST/train/{name}")
    return archive


def test_polymnist_download_goes_through_fetch_and_extract(tmp_path, monkeypatch):
    """``download=True`` with ``urlretrieve`` copying a local archive: the
    zenodo URL is asked for, the archive extracted and deleted, and the
    dataset equal to the JAX package's from its own download."""
    archive = _polymnist_zip(tmp_path)
    urls = []

    def fake_urlretrieve(url, dest):
        urls.append(url)
        shutil.copy(archive, dest)

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    ours = MMNISTDataset(str(tmp_path / "ours"), split="train", download=True)
    ref = JMMNISTDataset(str(tmp_path / "ref"), split="train", download=True)
    assert urls == [download.DATASET_URLS["PolyMNIST"]] * 2
    assert download.DATASET_URLS == jdownload.DATASET_URLS
    assert not os.path.exists(tmp_path / "ours" / "PolyMNIST.zip")
    _assert_same_dataset(ours, ref)
    with pytest.raises(AttributeError, match="zenodo"):
        MMNISTDataset(str(tmp_path / "empty"), split="train")


# ------------------------------------------------------- MNIST, SVHN, labels
@pytest.mark.parametrize("gz", [False, True])
def test_idx_reader_matches_jax(tmp_path, gz):
    root = dataset_files.write_mnist(str(tmp_path), N_MNIST, 16, seed=0, gz=gz)
    for train in (True, False):
        _assert_tree_equal(load_mnist(root, train), j_load_mnist(root, train))
    images, labels = load_mnist(root, True)
    assert images.shape == (N_MNIST, 28, 28) and images.dtype == np.uint8
    assert labels.dtype == np.int64 and sorted(set(labels)) == list(range(10))


def test_mnist_svhn_pairing_files_are_jax_byte_for_byte(tmp_path):
    """Each package pairs its own copy of the files: the cached index files
    are equal byte for byte, the pairs and labels exactly; a reload reads
    the cache (here both read the JAX package's)."""
    src = dataset_files.write_mnist(str(tmp_path / "src"), N_MNIST, 16, seed=0)
    dataset_files.write_svhn(src, "train", 50, seed=1)
    dataset_files.write_svhn(src, "test", 30, seed=2)
    for split in ("train", "test"):
        a, b = _copy(src, tmp_path / f"ours_{split}"), _copy(src, tmp_path / f"ref_{split}")
        ours = MnistSvhn(a, split=split, data_multiplication=2)
        ref = JMnistSvhn(b, split=split, data_multiplication=2)
        for name in ("mnist_idx.npy", "svhn_idx.npy"):
            with open(os.path.join(ours.path_to_idx, name), "rb") as f, \
                    open(os.path.join(ref.path_to_idx, name), "rb") as g:
                assert f.read() == g.read(), (split, name)
        _assert_same_dataset(ours, ref)
        _assert_tree_equal(ours.data, ref.data)
        # the pairs share their digit
        assert len(ours) > 0 and ours.data["svhn"].shape[1:] == (3, 32, 32)
        # from the cache the rows come in another order than at the build
        # that wrote it (the order's draws then follow no pairing draws),
        # in both packages
        again, jagain = (cls(b, split=split, data_multiplication=2)
                         for cls in (MnistSvhn, JMnistSvhn))
        _assert_same_dataset(again, jagain)
        assert not np.array_equal(again.labels, ours.labels)
    with pytest.raises(AttributeError, match="split"):
        MnistSvhn(src, split="eval")


def test_mnist_labels_matches_jax(tmp_path):
    root = dataset_files.write_mnist(str(tmp_path), N_MNIST, 16, seed=3)
    for split in ("train", "test"):
        ours, ref = MnistLabels(root, split=split), JMnistLabels(root, split=split)
        _assert_same_dataset(ours, ref)
        assert ours[0]["data"]["labels"].shape == (1, 10)


# ------------------------------------------------------------------------ MHD
def test_mhd_matches_jax(tmp_path):
    """The ``.pt`` tuple, the audio unstacked to (1, 32, 96); complete, and
    MNAR with per-class missing probabilities (``default_rng(seed + i)``)."""
    rng = np.random.default_rng(3)
    n = 30
    torch.save((torch.tensor(np.arange(n) % 10),
                torch.tensor(rng.uniform(size=(n, 1, 28, 28)).astype(np.float32)),
                torch.tensor(rng.normal(size=(n, 200)).astype(np.float32)),
                torch.tensor(rng.normal(size=(n, 3, 32, 32)).astype(np.float32)),
                (0.5, 2.0), (1.5, 3.0)), str(tmp_path / "mhd_train.pt"))
    ours, ref = MHD(str(tmp_path)), JMHD(str(tmp_path))
    _assert_same_dataset(ours, ref)
    assert ours.masks is None and ours[0]["data"]["audio"].shape == (1, 32, 96)
    assert ours.get_audio_normalization() == (1.5, 3.0)
    assert ours.get_traj_normalization() == (0.5, 2.0)
    probs = {m: [0.0] * 10 for m in ("label", "audio", "trajectory", "image")}
    probs["image"] = [1.0] + [0.2] * 9
    probs["audio"] = [0.5] * 10
    kw = dict(missing_probabilities=probs, seed=4, modalities=("image", "audio", "label"))
    ours, ref = MHD(str(tmp_path), **kw), JMHD(str(tmp_path), **kw)
    assert ours.is_incomplete and not ours.masks["image"][ours.labels == 0].any()
    _assert_same_dataset(ours, ref)
    _assert_tree_equal(ours.data, ref.data)
    with pytest.raises(RuntimeError, match="gdown"):
        MHD(str(tmp_path), split="test")


# -------------------------------------------------------------------- CelebA
def test_celeba_matches_jax(tmp_path):
    from PIL import Image

    base = tmp_path / "celeba"
    (base / "img_align_celeba").mkdir(parents=True)
    rng = np.random.default_rng(4)
    names = [f"{i:06d}.jpg" for i in range(1, 8)]
    for name in names:
        Image.fromarray(rng.integers(0, 256, (109, 89, 3), dtype=np.uint8)).save(
            base / "img_align_celeba" / name)
    with open(base / "list_attr_celeba.txt", "w") as f:
        f.write(f"{len(names)}\n" + " ".join(f"attr{i}" for i in range(40)) + "\n")
        for name in names:
            f.write(name + " " + " ".join(str(v) for v in rng.choice([-1, 1], 40)) + "\n")
    with open(base / "list_eval_partition.txt", "w") as f:
        for i, name in enumerate(names):
            f.write(f"{name} {i % 3}\n")
    for split, attributes in (("train", "18"), ("valid", "40"), ("test", "18"), ("all", "40")):
        ours = CelebAttr(str(tmp_path), split, attributes=attributes)
        ref = JCelebAttr(str(tmp_path), split, attributes=attributes)
        _assert_same_dataset(ours, ref, rows=(0, 1))
        assert ours.attr_names == ref.attr_names
        assert ours[0]["data"]["image"].shape == (3, 64, 64)


# ----------------------------------------------------------------------- CUB
def _cub_files(tmp_path, image_ext="png", size=(64, 64)):
    src = dataset_files.write_cub(str(tmp_path / "src"), n_train=3, n_test=2, seed=6,
                                  size=size)
    if image_ext == "jpg":
        from PIL import Image

        for split in ("train", "test"):
            for folder, _, files in os.walk(os.path.join(src, "cub", split)):
                for f in files:
                    path = os.path.join(folder, f)
                    Image.open(path).convert("RGB").save(path[:-4] + ".jpg")
                    os.remove(path)
    return src


def test_cub_vocabulary_and_captions_are_jax_byte_for_byte(tmp_path):
    """Each package tokenizes its own copy: ``cub.vocab.json`` and the
    captions' ``cub.<split>.s<L>.json`` are equal byte for byte (both take
    the same tokenizer on one machine), and so is every split's data, in
    both output types; eval is the JAX package's 10% of train."""
    src = _cub_files(tmp_path)
    ours_root, ref_root = _copy(src, tmp_path / "ours"), _copy(src, tmp_path / "ref")
    for split in ("train", "eval", "test"):
        for output_type in ("tokens", "one_hot"):
            ours = CUB(ours_root, split, max_words_in_caption=16, output_type=output_type)
            ref = JCUB(ref_root, split, max_words_in_caption=16, output_type=output_type)
            assert ours.vocab_size == ref.vocab_size > 4
            _assert_same_dataset(ours, ref, rows=(0, 2, 5))
    gen = os.path.join("cub", "oc_3_msl_16")
    files = sorted(os.listdir(os.path.join(ref_root, gen)))
    assert files == ["cub.test.s16.json", "cub.train.s16.json", "cub.vocab.json"]
    assert sorted(os.listdir(os.path.join(ours_root, gen))) == files
    for name in files:
        with open(os.path.join(ours_root, gen, name), "rb") as f, \
                open(os.path.join(ref_root, gen, name), "rb") as g:
            assert f.read() == g.read(), name
    sentences = CUBSentences(ours_root, "test", output_type="one_hot", max_sequence_length=16)
    jsentences = JCUBSentences(ref_root, "test", output_type="one_hot", max_sequence_length=16)
    rows = np.stack([sentences[i]["one_hot"] for i in range(3)])
    assert sentences.one_hot_to_string(rows) == jsentences.one_hot_to_string(rows)
    assert sentences.one_hot_to_string(rows[0]) == jsentences.one_hot_to_string(rows[0])
    assert (sentences.pad_idx, sentences.eos_idx, sentences.unk_idx) == (0, 1, 2)


def test_cub_jpg_images_and_resize_match_jax(tmp_path):
    """JPG images, and PNGs of another size, go through PIL as in the JAX
    package (an image transform too)."""
    for ext, size in (("jpg", (64, 64)), ("png", (40, 48))):
        src = _cub_files(tmp_path / ext, image_ext=ext, size=size)
        kw = dict(max_words_in_caption=8, im_size=(32, 32), img_transform=lambda a: a * 2.0)
        _assert_same_dataset(CUB(src, "test", **kw), JCUB(src, "test", **kw))


# ---------------------------------------------------------- TranslatedMMNIST
def test_translated_polymnist_generation_matches_jax(tmp_path):
    """Each package generates from its own copy of MNIST and two background
    JPGs. The digit is shrunk by the antialiased bilinear resize and
    binarized at 128: a pixel can differ only where the two resizes fall on
    both sides of 128. The count of such pixels, from the resizes of every
    digit, is the count of differing pixels in the PNGs (each digit is drawn
    once a modality); a PNG whose pixels agree is equal byte for byte. The
    port reads the JAX package's tree as the JAX package does."""
    from PIL import Image

    src = dataset_files.write_mnist(str(tmp_path / "src"), N_MNIST, 16, seed=0)
    bg = tmp_path / "src" / "backgrounds"
    bg.mkdir()
    rng = np.random.default_rng(5)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (64, 60, 3), dtype=np.uint8)).save(bg / f"b{i}.jpg")
    ours_root, ref_root = _copy(src, tmp_path / "ours"), _copy(src, tmp_path / "ref")
    kw = dict(scale=0.75, translate=True, n_modalities=2, split="train", seed=3)
    ours = TranslatedMMNIST(ours_root, background_path=os.path.join(ours_root, "backgrounds"), **kw)
    ref = JTranslatedMMNIST(ref_root, background_path=os.path.join(ref_root, "backgrounds"), **kw)

    images, _ = load_mnist(src, True)
    small = int(28 * 0.75)
    flips, gap = 0, 0.0
    for image in images.astype(np.float32):
        port = shrink_digit(image, small)
        jax_resized = np.asarray(jax.image.resize(jnp.asarray(image), (small, small), "bilinear"))
        flips += int(((port > 128) != (jax_resized > 128)).sum())
        gap = max(gap, float(np.abs(port - jax_resized).max()))
    assert gap < 1e-4 * 255      # float32 rounding of values up to 255

    assert len(ours) == len(ref) == N_MNIST
    differing, byte_equal = 0, 0
    for dp, jdp in zip(ours.file_paths, ref.file_paths):
        names = [os.path.basename(p) for p in ours.file_paths[dp]]
        assert names == [os.path.basename(p) for p in ref.file_paths[jdp]]
        for a, b in zip(ours.file_paths[dp], ref.file_paths[jdp]):
            pa, pb = utils.read_png(a), utils.read_png(b)
            n = int((pa != pb).any(-1).sum())
            differing += n
            with open(a, "rb") as f, open(b, "rb") as g:
                same = f.read() == g.read()
            byte_equal += same
            assert same == (n == 0), a
    assert differing == 2 * flips
    # with these files no resized value lies within rounding of 128: every
    # generated PNG is the JAX package's, byte for byte
    assert flips == 0 and byte_equal == 2 * N_MNIST
    reread = TranslatedMMNIST(ref_root, **kw)
    _assert_same_dataset(reread, ref)
    with pytest.raises(ValueError, match="background"):
        TranslatedMMNIST(str(tmp_path / "none"), **kw)


def test_port_reads_png_datasets_without_pil(tmp_path):
    """With PIL blocked: CUB(output_type="tokens") on PNGs at ``im_size`` and
    a Translated PolyMNIST tree load; generation asks for Pillow by name."""
    src = dataset_files.write_cub(str(tmp_path / "cub"), n_train=2, n_test=1, seed=1)
    tree = dataset_files.write_translated_polymnist(str(tmp_path / "tmm"), 6, seed=2)
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from multivae_tpu_torch.data.datasets import CUB, TranslatedMMNIST\n"
        f"ds = CUB({src!r}, 'train', output_type='tokens')\n"
        "batch = ds.get_batch(np.arange(4))\n"
        "assert batch['data']['image'].shape == (4, 3, 64, 64)\n"
        "assert batch['data']['text']['tokens'].shape == (4, 32)\n"
        f"tm = TranslatedMMNIST({tree!r}, 0.75, True, 5)\n"
        "assert tm.get_batch(np.arange(6))['data']['m4'].shape == (6, 3, 28, 28)\n"
        "try:\n"
        f"    TranslatedMMNIST({str(tmp_path / 'new')!r}, 0.75, True, 2, background_path='.')\n"
        "except ImportError as e:\n"
        "    assert 'Pillow' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('generation ran without Pillow')\n"
        "assert not [k for k in sys.modules if k.split('.')[0] == 'PIL'\n"
        "            and sys.modules[k] is not None]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stdout + proc.stderr


# ----------------------------------------------------------------- PNG reader
def _png_with_filters(path, image):
    """Write ``image`` (H, W, C) uint8 with scanline y filtered by type
    y % 5 (none, sub, up, average, Paeth), as an encoder may choose."""
    h, w, c = image.shape
    rows = image.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    out = bytearray()
    for y in range(h):
        kind, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if kind == 0:
            line = cur
        elif kind == 1:
            line = cur - left
        elif kind == 2:
            line = cur - prev
        elif kind == 3:
            line = cur - (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
            line = cur - pred
        out += bytes([kind]) + (line & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    idat = zlib.compress(bytes(out))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                                                  0, 0, 0))
                + chunk(b"IDAT", idat[:7]) + chunk(b"IDAT", idat[7:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_matches_pil(tmp_path, channels):
    """All five scanline filters, over two IDAT chunks, for grey, grey+alpha,
    RGB and RGBA; PIL's own files too; ``write_png`` round-trips."""
    from PIL import Image

    rng = np.random.default_rng(channels)
    image = rng.integers(0, 256, (11, 9, channels), dtype=np.uint8)
    path = str(tmp_path / "filters.png")
    _png_with_filters(path, image)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil.reshape(image.shape), image)
    np.testing.assert_array_equal(utils.read_png(path), image)
    smooth = np.sort(rng.integers(0, 256, (17, 13, channels), dtype=np.uint8), axis=1)
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(smooth.squeeze(-1) if channels == 1 else smooth, mode).save(tmp_path / "pil.png")
    np.testing.assert_array_equal(utils.read_png(str(tmp_path / "pil.png")), smooth)
    if channels == 3:
        utils.write_png(str(tmp_path / "w.png"), image)
        np.testing.assert_array_equal(utils.read_png(str(tmp_path / "w.png")), image)
    Image.fromarray(image[..., 0], "L").convert("P").save(tmp_path / "palette.png")
    with pytest.raises(ValueError, match="colour type 3"):
        utils.read_png(str(tmp_path / "palette.png"))


# --------------------------------------------------------- download helpers
def test_download_helpers_match_jax(tmp_path, monkeypatch):
    """``extract_archive`` on zip and tar.gz (a member leaving the folder is
    refused by both), ``sha256_of``, ``fetch_and_extract`` with
    ``urlretrieve`` copying a local archive (a mismatching checksum deletes
    it, a failed download names the URL), and ``maybe_download_cub``."""
    payload = tmp_path / "payload"
    payload.mkdir()
    (payload / "inner.txt").write_text("hello")
    zpath, tpath, bad = tmp_path / "a.zip", tmp_path / "a.tar.gz", tmp_path / "bad.tar"
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.write(payload / "inner.txt", "cub/inner.txt")
    with tarfile.open(tpath, "w:gz") as tf:
        tf.add(payload / "inner.txt", "cub/inner.txt")
    with tarfile.open(bad, "w") as tf:
        tf.add(payload / "inner.txt", "../escape.txt")
    for archive in (zpath, tpath):
        for name, fn in (("ours", download.extract_archive), ("ref", jdownload.extract_archive)):
            fn(str(archive), str(tmp_path / f"{name}_{archive.name}"))
            assert (tmp_path / f"{name}_{archive.name}" / "cub" / "inner.txt").read_text() == "hello"
    for fn in (download.extract_archive, jdownload.extract_archive):
        with pytest.raises(tarfile.OutsideDestinationError):
            fn(str(bad), str(tmp_path / "bad_out"))
        with pytest.raises(ValueError, match="Unsupported"):
            fn(str(payload / "inner.txt"), str(tmp_path / "x"))
    assert not (tmp_path / "escape.txt").exists()
    assert download.sha256_of(str(tpath)) == jdownload.sha256_of(str(tpath))
    assert download.sha256_of(str(tpath), chunk=7) == download.sha256_of(str(tpath))

    urls = []

    def fake_urlretrieve(url, dest):
        urls.append(url)
        shutil.copy(zpath, dest)

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    digest = download.sha256_of(str(zpath))
    out = download.fetch_and_extract("http://mirror/a.zip?x=1", str(tmp_path / "f"),
                                     sha256=digest.upper(), keep_archive=True)
    assert (tmp_path / "f" / "cub" / "inner.txt").read_text() == "hello"
    assert out == str(tmp_path / "f") and (tmp_path / "f" / "a.zip").exists()
    for fn in (download.fetch_and_extract, jdownload.fetch_and_extract):
        with pytest.raises(RuntimeError, match="Checksum mismatch"):
            fn("http://mirror/a.zip", str(tmp_path / "g"), sha256="0" * 64)
        assert not (tmp_path / "g" / "a.zip").exists()
    download.maybe_download_cub(str(tmp_path / "c"))
    assert (tmp_path / "c" / "cub" / "inner.txt").exists()
    assert not (tmp_path / "c" / "cub.zip").exists()
    assert urls[-1] == download.DATASET_URLS["CUB"]

    def broken(url, dest):
        raise OSError("unreachable")

    monkeypatch.setattr(urllib.request, "urlretrieve", broken)
    for fn in (download.fetch_and_extract, jdownload.fetch_and_extract):
        with pytest.raises(RuntimeError, match="Download manually from http://mirror/y.zip"):
            fn("http://mirror/y.zip", str(tmp_path / "y"))


# ------------------------------------------- nested modalities and helpers
def _nested(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(size=(n, 3, 4, 4)).astype(np.float32),
            "text": {"tokens": rng.integers(0, 9, (n, 5)),
                     "padding_mask": (rng.uniform(size=(n, 5)) > 0.3).astype(np.float32)}}


def test_nested_modalities_in_datasets_batches_and_loader():
    """A token-dict modality: the dataset's length and rows, its length
    check, the batch's rows and move, and the loader's batches (with the
    wrap-around padding) against the JAX package's."""
    data, masks = _nested(10), {"image": np.arange(10) % 3 > 0, "text": np.ones(10, bool)}
    for ours, ref in ((MultimodalBaseDataset(data, labels=np.arange(10)),
                       JDataset(data, labels=np.arange(10))),
                      (IncompleteDataset(data, masks), JIncompleteDataset(data, masks))):
        _assert_same_dataset(ours, ref, rows=(9, 0, 4))
        loader = DataLoader(ours, batch_size=4, seed=3)
        jloader = JDataLoader(ref, batch_size=4, seed=3)
        loader.set_epoch(1)
        jloader.set_epoch(1)
        for batch, jbatch in zip(loader, jloader):
            assert batch.n_samples == jbatch.n_samples == 4
            _assert_tree_equal({k: jax.tree.map(lambda t: t.numpy(), v)
                                for k, v in batch.data.items()},
                               jax.tree.map(np.asarray, jbatch.data))
            np.testing.assert_array_equal(batch.weights.numpy(), np.asarray(jbatch.weights))
            np.testing.assert_array_equal(batch.masks["image"].numpy(),
                                          np.asarray(jbatch.masks["image"]))
    bad = _nested(10)
    bad["text"] = {k: v[:9] for k, v in bad["text"].items()}
    for cls in (MultimodalBaseDataset, JDataset):
        with pytest.raises(AttributeError, match="size"):
            cls(bad)

    batch = batch_from_arrays(_nested(6), masks={"image": np.ones(6), "text": np.ones(6)})
    jbatch = j_batch_from_arrays(_nested(6), masks={"image": np.ones(6), "text": np.ones(6)})
    assert batch.n_samples == jbatch.n_samples == 6 and batch.incomplete == jbatch.incomplete
    moved = batch.to("cpu")
    assert moved.data["text"]["tokens"].dtype == torch.int64
    assert torch.equal(moved.data["text"]["padding_mask"], batch.data["text"]["padding_mask"])


def test_get_batch_size_and_drop_unused_modalities_match_jax():
    data = _nested(6)
    for inputs in ({"data": data}, batch_from_arrays(data)):
        jinputs = ({"data": data} if isinstance(inputs, dict)
                   else j_batch_from_arrays(data))
        assert utils.get_batch_size(inputs) == jutils.get_batch_size(jinputs) == 6

    def inputs():
        return {"data": _nested(6), "masks": {"image": np.zeros(6, bool),
                                              "text": np.arange(6) > 3}}

    ours, ref = utils.drop_unused_modalities(inputs()), jutils.drop_unused_modalities(inputs())
    assert list(ours["data"]) == list(ref["data"]) == ["text"]
    assert list(ours["masks"]) == list(ref["masks"]) == ["text"]
    dataset = IncompleteDataset(_nested(6), {"image": np.zeros(6, bool),
                                             "text": np.ones(6, bool)})
    out = dataset.get_batch(np.arange(3))
    assert list(utils.drop_unused_modalities(out)["data"]) == ["text"]
    complete = {"data": _nested(6)}
    assert utils.drop_unused_modalities(complete) is complete and len(complete["data"]) == 2
