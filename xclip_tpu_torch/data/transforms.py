"""Eval image preprocessing -> NHWC float32 numpy.

A copy of the eval path of ``xclip_tpu/data/transforms.py``
(``image_transform(..., is_train=False)`` with its defaults): shortest-side
bicubic resize, centre crop, OpenAI mean/std. Byte-identical on the same
PIL image. The training augmentations come with the training slice.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize(arr: np.ndarray) -> np.ndarray:
    """uint8 HWC -> normalized float32 HWC."""
    arr = arr.astype(np.float32) / 255.0
    return (arr - np.asarray(OPENAI_DATASET_MEAN, np.float32)) / np.asarray(OPENAI_DATASET_STD, np.float32)


def resize_shortest(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(1, int(round(size * h / w)))
    else:
        new_w, new_h = max(1, int(round(size * w / h))), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    """Crop the centre ``size`` square; the image is at least that large
    after :func:`resize_shortest`."""
    w, h = img.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


class ImageTransform:
    """Callable PIL.Image -> float32 HWC array."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = img.convert("RGB") if img.mode != "RGB" else img
        img = center_crop(resize_shortest(img, self.size), self.size)
        return normalize(np.asarray(img))


def image_transform(image_size: int, is_train: bool = False) -> ImageTransform:
    if is_train:
        raise NotImplementedError("training augmentations come with the training slice")
    return ImageTransform(image_size)
