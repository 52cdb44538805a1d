"""Contrastive loss, single process.

Counterpart of ``xclip_tpu/train/loss.py:clip_loss`` without ``axis_name``
(:34-59): one device holds the whole batch, so ``--local-loss`` and
``--gather-with-grad`` change nothing at world size 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE: fp32 logits ``scale * img @ txt^T``, the mean of
    the image->text and text->image cross-entropies against the diagonal."""
    logits = (logit_scale * image_features.float()) @ text_features.float().t()
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2
