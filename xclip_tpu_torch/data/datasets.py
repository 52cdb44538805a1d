"""Dataset indexes: ImageNet folders, the DomainNet TSVs, and the training
sets.

Copies from ``xclip_tpu/data/datasets.py``:

- ``ImageFolderIndex``, ``ImageNet``, ``DomainNetCaptions`` and
  ``DOMAIN_TO_IDX`` (:26-100, :222-268), without class remapping or
  filtering; ``DomainNetCaptions(mode=...)`` returns the image with its
  label, or alone (``mode="none"``, the SAE feature cache);
  batched by ``torch.utils.data.DataLoader`` (``evals/features.py``) or
  ``data/loader.py`` (``sae/cache.py``);
- ``TsvDataset`` (``filepath\\ttitle``) and ``SyntheticDataset`` (:270-375),
  (image, caption) samples for training, or the image alone
  (``return_caption=False``), batched by ``data/loader.py``.

``__getitem__`` returns numpy samples.
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence, Tuple

import numpy as np
from PIL import Image

ALL_DOMAINS = ["clipart", "infograph", "painting", "quickdraw", "real", "sketch"]
DOMAIN_TO_IDX = {d: i for i, d in enumerate(ALL_DOMAINS)}

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


class ImageFolderIndex:
    """torchvision-ImageFolder-equivalent index: classes are the sorted
    subdirectory names; samples are (path, class_idx)."""

    def __init__(self, root: str, transform: Callable):
        self.root = root
        self.transform = transform
        self.classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            cdir = os.path.join(root, cls)
            files = sorted(
                os.path.join(cdir, f) for f in os.listdir(cdir) if f.lower().endswith(IMG_EXTENSIONS)
            )
            self.samples.extend((f, self.class_to_idx[cls]) for f in files)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, label = self.samples[index]
        return self.transform(Image.open(path).convert("RGB")), label


class ImageNet(ImageFolderIndex):
    """ImageNet ``root/{train,val}/<wnid>/``; labels index the sorted wnids."""

    def __init__(self, root: str, split: str, transform: Callable):
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split!r}")
        super().__init__(os.path.join(root, split), transform)


class DomainNetCaptions:
    """Per-domain DomainNet TSV index with domain exclusion. TSV rows:
    path\tlabel\tcaption; ``samples`` holds (path, label, caption). An item
    is (image, label) with ``mode="label"`` (the default), the image alone
    with ``mode="none"``."""

    def __init__(self, domainnet_path: str, split: str, transform: Callable,
                 exclude_domains: Sequence[str] = (), mode: str = "label"):
        domainnet_path = os.path.abspath(domainnet_path)
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split!r}")
        if mode not in ("none", "label"):
            raise ValueError(f"mode must be 'none' or 'label', got {mode!r}")
        self.return_label = mode == "label"
        split = "test" if split == "val" else split
        self.samples: List[Tuple[str, int, str]] = []
        for domain in ALL_DOMAINS:
            if domain in exclude_domains:
                continue
            with open(os.path.join(domainnet_path, f"{domain}_{split}.tsv")) as fh:
                rows = [line.split("\t") for line in fh.readlines()]
            self.samples.extend(
                (os.path.join(domainnet_path, p), int(label), caption.strip())
                for p, label, caption in rows
            )
        self.transform = transform

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, label, _ = self.samples[index]
        img = self.transform(Image.open(path))
        return (img, label) if self.return_label else img


class TsvDataset:
    """``filepath\ttitle`` TSV of (image path, caption) rows; samples are
    (transformed image, caption), or the image alone with
    ``return_caption=False``."""

    def __init__(self, tsv_path: str, img_transform: Callable, return_caption: bool = True):
        with open(tsv_path) as fh:
            lines = fh.readlines()
        if not lines or lines[0].strip("\n") != "filepath\ttitle":
            raise ValueError(f"{tsv_path}: the first line must be the header 'filepath\\ttitle'")
        self.samples = [line.strip("\n").split("\t") for line in lines[1:]]
        self.img_transform = img_transform
        self.return_caption = return_caption

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, caption = self.samples[index]
        img = self.img_transform(Image.open(path).convert("RGB"))
        return (img, caption) if self.return_caption else img


class SyntheticDataset:
    """Random images (16 distinct ones, seeded) with a fixed caption, for runs
    without data on disk."""

    def __init__(self, transform: Callable, image_size: int = 224, caption: str = "Dummy caption",
                 dataset_size: int = 100, seed: int = 0):
        self.transform = transform
        self.caption = caption
        rng = np.random.RandomState(seed)
        self._images = [
            Image.fromarray(rng.randint(0, 256, (image_size, image_size, 3), np.uint8))
            for _ in range(min(dataset_size, 16))
        ]
        self.size = dataset_size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int):
        return self.transform(self._images[index % len(self._images)]), self.caption
