"""Batched image-feature extraction (the eval hot loop).

Counterpart of ``xclip_tpu/evals/features.py``: decode and preprocess in
``torch.utils.data.DataLoader`` workers into pinned host memory, copy each
batch to the device without blocking, encode and L2-normalize there. PyTorch
runs eagerly, so the tail batch is not padded to a fixed shape.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader


def _collate(items):
    """(image HWC float32, label) samples -> (NHWC tensor, int32 labels)."""
    images = torch.from_numpy(np.stack([it[0] for it in items]))
    labels = torch.from_numpy(np.asarray([it[1] for it in items], np.int32))
    return images, labels


@torch.inference_mode()
def extract_image_features(
    model,
    dataset,
    *,
    batch_size: int = 250,
    num_workers: int = 8,
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, np.ndarray]:
    """Encode every image of ``dataset`` -> ``{"img_feat": (N, E) float32
    normalized, "clss": (N,) int32 labels}``, on the model's device."""
    device = next(model.parameters()).device
    loader = DataLoader(
        dataset, batch_size=batch_size, shuffle=False, num_workers=num_workers,
        collate_fn=_collate, pin_memory=device.type == "cuda",
        # spawned workers: the parent may hold CUDA state and threads
        multiprocessing_context="spawn" if num_workers > 0 else None,
    )
    feats: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    t0 = time.perf_counter()
    for images, clss in loader:
        if not feats:
            logging.info("first batch of %d images after %.2f s (worker start-up)",
                         images.shape[0], time.perf_counter() - t0)
        images = images.to(device, non_blocking=True)
        feats.append(model.encode_image(images, normalize=True, dtype=dtype).cpu().numpy())
        labels.append(clss.numpy())
    return {"img_feat": np.concatenate(feats, axis=0), "clss": np.concatenate(labels)}
