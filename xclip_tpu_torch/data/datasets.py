"""Eval dataset indexes: ImageNet folders and the DomainNet TSVs.

Copies of ``ImageFolderIndex``, ``ImageNet``, ``DomainNetCaptions`` and
``DOMAIN_TO_IDX`` from ``xclip_tpu/data/datasets.py`` (:26-100, :222-268),
with what the LSO evaluation uses: (image, label) samples, no class
remapping or captions. ``__getitem__`` returns numpy samples; batching,
worker processes and pinned memory are ``torch.utils.data.DataLoader``'s
job (``evals/features.py``).
"""

from __future__ import annotations

import os
from typing import Callable, List, Sequence, Tuple

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
    path\tlabel\tcaption; samples are (path, label, caption)."""

    def __init__(self, domainnet_path: str, split: str, transform: Callable,
                 exclude_domains: Sequence[str] = ()):
        domainnet_path = os.path.abspath(domainnet_path)
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split!r}")
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
        return self.transform(Image.open(path)), label
