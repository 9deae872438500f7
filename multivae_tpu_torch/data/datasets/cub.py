"""CUB birds: images paired with captions, and the caption vocabulary
(counterpart of ``multivae_tpu/data/datasets/cub.py``).

Expects the mmdgm ``cub`` folder: ``text_trainvalclasses.txt`` and
``text_testclasses.txt`` (one caption a line, 10 an image), and image
class folders under ``cub/train`` and ``cub/test``. ``CUBSentences``
builds the vocabulary from the train captions and caches it, with the
tokenized captions, as JSON under ``oc_<min_occ>_msl_<L>``: the same
files as the JAX package's. Tokenizing uses nltk when it imports (and has
its data), else a regular expression, as the JAX package does, so both
build the same vocabulary on the same machine (the port asks once whether
nltk works, where the JAX package tries it at every caption).

PNG images at ``im_size`` are read without an image package
(``data/utils.png_to_chw``); a JPG or an image to resize needs Pillow.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import re
from collections import Counter, OrderedDict

import numpy as np

from ..utils import import_pil, png_to_chw
from .base import DatasetOutput, MultimodalBaseDataset

logger = logging.getLogger(__name__)


@functools.lru_cache(maxsize=None)
def _nltk_tokenizers():
    """nltk's (sent_tokenize, word_tokenize) when they import and run (their
    data installed), else None; probed once, not at every caption."""
    try:
        from nltk.tokenize import sent_tokenize, word_tokenize

        word_tokenize("a probe.")
        sent_tokenize("a probe. another one.")
        return sent_tokenize, word_tokenize
    except Exception:   # no nltk, or no punkt data
        return None


def _tokenize(sentence: str):
    nltk = _nltk_tokenizers()
    if nltk is not None:
        try:
            return nltk[1](sentence.lower())
        except Exception:
            pass
    return re.findall(r"[\w']+|[.,!?;]", sentence.lower())


def _split_sentences(text: str):
    nltk = _nltk_tokenizers()
    if nltk is not None:
        try:
            return nltk[0](text)
        except Exception:
            pass
    return [s.strip() + "." for s in text.split(".") if s.strip()]


class CUBSentences:
    """Tokenized CUB captions: special tokens {<pad>=0, <eos>=1, <unk>=2,
    <exc>=3}, then the train captions' words seen at least ``min_occ``
    times; each caption cut to ``max_sequence_length - 1`` words, ended by
    <eos> and padded. Items are ``{"one_hot", "padding_mask"}`` or
    ``{"tokens", "padding_mask"}`` (``output_type``)."""

    special_tokens = ["<pad>", "<eos>", "<unk>", "<exc>"]

    def __init__(self, root_data_dir: str, split: str, output_type: str = "one_hot",
                 transform=None, max_sequence_length: int = 32, min_occ: int = 3):
        self.split = split
        self.data_dir = os.path.join(root_data_dir, "cub")
        self.max_sequence_length = max_sequence_length
        self.min_occ = min_occ
        self.output_type = output_type
        self.transform = transform
        self.gen_dir = os.path.join(self.data_dir, f"oc_{min_occ}_msl_{max_sequence_length}")
        os.makedirs(self.gen_dir, exist_ok=True)
        self.raw_data_path = os.path.join(
            self.data_dir,
            "text_trainvalclasses.txt" if split == "train" else "text_testclasses.txt")
        self.data_file = f"cub.{split}.s{max_sequence_length}.json"
        self.vocab_file = "cub.vocab.json"
        self._load_data()

    def _load_vocab(self):
        path = os.path.join(self.gen_dir, self.vocab_file)
        if not os.path.exists(path):
            self._create_vocab()
        with open(path) as f:
            vocab = json.load(f)
        self.w2i, self.i2w = vocab["w2i"], vocab["i2w"]

    def _create_vocab(self):
        with open(os.path.join(self.data_dir, "text_trainvalclasses.txt")) as f:
            sentences = _split_sentences(f.read())
        occ = Counter()
        w2i, i2w = OrderedDict(), OrderedDict()
        for st in self.special_tokens:
            i2w[str(len(w2i))] = st
            w2i[st] = len(w2i)
        for sentence in sentences:
            occ.update(_tokenize(sentence))
        for word, count in occ.items():
            if count >= self.min_occ and word not in self.special_tokens:
                i2w[str(len(w2i))] = word
                w2i[word] = len(w2i)
        with open(os.path.join(self.gen_dir, self.vocab_file), "w") as f:
            json.dump({"w2i": w2i, "i2w": i2w}, f)

    def _load_data(self):
        self._load_vocab()
        path = os.path.join(self.gen_dir, self.data_file)
        if not os.path.exists(path):
            self._create_data()
        with open(path) as f:
            self.data = json.load(f)

    def _create_data(self):
        with open(self.raw_data_path) as f:
            sentences = _split_sentences(f.read())
        data = {}
        for i, line in enumerate(sentences):
            tok = _tokenize(line)[: self.max_sequence_length - 1] + ["<eos>"]
            length = len(tok)
            tok.extend(["<pad>"] * (self.max_sequence_length - length))
            data[str(i)] = {"idx": [self.w2i.get(w, self.w2i["<exc>"]) for w in tok],
                            "length": length}
        with open(os.path.join(self.gen_dir, self.data_file), "w") as f:
            json.dump(data, f)

    @property
    def vocab_size(self):
        return len(self.w2i)

    @property
    def pad_idx(self):
        return self.w2i["<pad>"]

    @property
    def eos_idx(self):
        return self.w2i["<eos>"]

    @property
    def unk_idx(self):
        return self.w2i["<unk>"]

    def get_w2i(self):
        return self.w2i

    def get_i2w(self):
        return self.i2w

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        entry = self.data[str(int(idx))]
        tokens = np.asarray(entry["idx"], np.int64)
        padding_mask = (np.arange(self.max_sequence_length)
                        < entry["length"]).astype(np.float32)
        if self.output_type == "tokens":
            return {"tokens": tokens, "padding_mask": padding_mask}
        one_hot = np.eye(self.vocab_size, dtype=np.float32)[tokens]
        return {"one_hot": one_hot, "padding_mask": padding_mask}

    def one_hot_to_string(self, data):
        """The words of (L, V) or (N, L, V) one-hot (or logit) rows, one
        string a row."""
        ids = np.argmax(np.asarray(data), axis=-1)
        return [" ".join(self.i2w[str(int(i))] for i in row) for row in np.atleast_2d(ids)]


class CUB(MultimodalBaseDataset):
    """Paired image-caption CUB: caption i goes with image i // 10 of its
    split. 'train' and 'eval' split the train captions 90/10 by a
    ``default_rng(0)`` permutation.

    Args:
        path: folder holding ``cub``.
        split: 'train', 'eval' or 'test'.
        max_words_in_caption: caption length L, <eos> and padding included.
        im_size: (H, W) of the images.
        img_transform: callable on each (3, H, W) image.
        output_type: 'one_hot' or 'tokens' (the text modality's dict).
        download: fetch the mirror's archive when ``cub`` is absent.
    """

    def __init__(self, path: str, split: str = "train", max_words_in_caption: int = 32,
                 im_size=(64, 64), img_transform=None, output_type: str = "one_hot",
                 download: bool = False):
        if not os.path.exists(os.path.join(path, "cub")):
            if download:
                from ..download import maybe_download_cub

                maybe_download_cub(path)
            if not os.path.exists(os.path.join(path, "cub")):
                raise AttributeError(
                    "The CUB dataset is not available at the given datapath. Pass "
                    "download=True or place the oxford mmdgm cub folder there.")
        self.split = split
        self.path = path
        self.im_size = tuple(im_size)
        self.img_transform = img_transform
        self.output_type = output_type

        base_split = "train" if split == "eval" else split
        self.text_data = CUBSentences(path, base_split, output_type=output_type,
                                      max_sequence_length=max_words_in_caption)
        img_dir = os.path.join(path, "cub", base_split)
        self.image_files = []
        for cls in sorted(os.listdir(img_dir)):
            cls_dir = os.path.join(img_dir, cls)
            if os.path.isdir(cls_dir):
                self.image_files.extend(
                    os.path.join(cls_dir, f) for f in sorted(os.listdir(cls_dir))
                    if f.lower().endswith((".jpg", ".jpeg", ".png")))
        if split in ("train", "eval"):
            idx = np.random.default_rng(0).permutation(len(self.text_data))
            n_val = max(1, int(0.1 * len(idx)))
            self.val_idx = idx[:n_val]
            self.train_idx = idx[n_val:]
        self.vocab_size = self.text_data.vocab_size

    def _load_image(self, file):
        arr = None
        if file.lower().endswith(".png"):
            arr = png_to_chw(file)
            if arr.shape[1:] != self.im_size:
                arr = None
        if arr is None:   # a JPG, or a PNG to resize
            Image = import_pil("Reading CUB's JPG images or resizing them")
            with Image.open(file) as img:
                img = img.convert("RGB").resize(self.im_size[::-1])
            arr = np.transpose(np.asarray(img, np.float32) / 255.0, (2, 0, 1))
        if self.img_transform is not None:
            arr = self.img_transform(arr)
        return arr

    def __len__(self):
        if self.split == "train":
            return len(self.train_idx)
        if self.split == "eval":
            return len(self.val_idx)
        return len(self.text_data)

    def __getitem__(self, index):
        if self.split == "train":
            index = int(self.train_idx[index])
        elif self.split == "eval":
            index = int(self.val_idx[index])
        return DatasetOutput(data=dict(image=self._load_image(self.image_files[index // 10]),
                                       text=self.text_data[index]))

    def get_batch(self, indices):
        outs = [self[int(i)] for i in indices]
        text = {k: np.stack([o["data"]["text"][k] for o in outs])
                for k in outs[0]["data"]["text"]}
        return DatasetOutput(data=dict(image=np.stack([o["data"]["image"] for o in outs]),
                                       text=text))
