"""Image preprocessing -> NHWC numpy.

Copies of two paths of ``xclip_tpu/data/transforms.py`` with its defaults,
byte-identical on the same PIL image (and, for training, the same
``random.Random`` seed):

- eval (``image_transform(..., is_train=False)``): shortest-side bicubic
  resize, centre crop, OpenAI mean/std -> float32;
- train (``is_train=True, to_uint8=True``): ``random_resized_crop`` with
  scale (0.9, 1.0), bicubic -> uint8; the train step normalizes on the
  device (``train.step.normalize_images``).
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

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


def random_resized_crop(
    img: Image.Image,
    size: int,
    *,
    scale: Tuple[float, float] = (0.9, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    rng: Optional[random.Random] = None,
) -> Image.Image:
    """torchvision-equivalent RandomResizedCrop sampling, bicubic."""
    rng = rng or random
    width, height = img.size
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h)
            j = rng.randint(0, width - w)
            return img.resize((size, size), Image.BICUBIC, box=(j, i, j + w, i + h))
    # fallback: center crop to in-range aspect
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        w, h = int(round(height * ratio[1])), height
    else:
        w, h = width, height
    i, j = (height - h) // 2, (width - w) // 2
    return img.resize((size, size), Image.BICUBIC, box=(j, i, j + w, i + h))


class ImageTransform:
    """Callable PIL.Image -> HWC array: float32 normalized (eval) or uint8
    random-resized crop (train)."""

    def __init__(self, size: int, is_train: bool = False, seed: Optional[int] = None):
        self.size = size
        self.is_train = is_train
        # None = the global ``random``; a module cannot be pickled into
        # DataLoader worker processes, so it is not stored
        self.rng = random.Random(seed) if seed is not None else None

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = img.convert("RGB") if img.mode != "RGB" else img
        if self.is_train:
            img = random_resized_crop(img, self.size, rng=self.rng)
            return np.asarray(img, dtype=np.uint8)
        img = center_crop(resize_shortest(img, self.size), self.size)
        return normalize(np.asarray(img))


def image_transform(image_size: int, is_train: bool = False, seed: Optional[int] = None) -> ImageTransform:
    """Eval transform, or with ``is_train`` the uint8 train transform whose
    crops come from ``random.Random(seed)`` (the global ``random`` when
    ``seed`` is None, as in the JAX package)."""
    return ImageTransform(image_size, is_train, seed)
