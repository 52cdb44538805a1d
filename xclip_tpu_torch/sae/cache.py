"""CLIP image-feature caching for SAE training.

Counterpart of ``xclip_tpu/sae/cache.py``: encode every image of a dataset
with the CLIP image tower (fp32, L2-normalized), in the order of the port's
threaded loader shuffled at ``seed`` (the JAX loader's order), and write
fp16 shards permuted by ``np.random.RandomState(seed)``: one
``{prefix}.npy``, or with ``shard_batches`` one ``{prefix}_{i}.npy`` every
that many batches. The JAX package pads the last batch to ``batch_size``
(its encoder is compiled for one shape) and drops the pad's features;
PyTorch runs eagerly and each image's features do not depend on the rest
of its batch, so the port encodes the last batch as it is.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from xclip_tpu_torch.data.loader import DataLoader


class _ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index):
        ds_idx = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[ds_idx][index - self._offsets[ds_idx]]


def concat_datasets(datasets: Sequence) -> _ConcatDataset:
    return _ConcatDataset(datasets)


@torch.inference_mode()
def cache_image_features(
    model,
    dataset,
    out_path: str,
    *,
    batch_size: int = 1024,
    num_threads: int = 8,
    shard_batches: Optional[int] = None,
    seed: int = 0,
    prefix: str = "train_activations",
) -> List[str]:
    """Encode every image of ``dataset`` (samples: an image, or a tuple whose
    first element is one) with ``model`` on its device; return the shard
    paths."""
    os.makedirs(out_path, exist_ok=True)
    device = next(model.parameters()).device
    loader = DataLoader(dataset, batch_size, shuffle=True, seed=seed, num_threads=num_threads)
    rng = np.random.RandomState(seed)
    paths: List[str] = []
    buf: List[np.ndarray] = []

    def flush():
        if not buf:
            return
        feats = np.concatenate(buf).astype(np.float16)
        feats = feats[rng.permutation(len(feats))]
        name = f"{prefix}.npy" if shard_batches is None else f"{prefix}_{len(paths)}.npy"
        path = os.path.join(out_path, name)
        np.save(path, feats)
        paths.append(path)
        buf.clear()

    for batch in loader:
        images = torch.from_numpy(batch[0] if isinstance(batch, tuple) else batch).to(device)
        feats = model.encode_image(images, normalize=True)
        buf.append(feats.cpu().numpy())
        if shard_batches is not None and len(buf) >= shard_batches:
            flush()
    flush()
    return paths
