"""SAE losses: L1 sparsity penalty + L2 reconstruction, summed.

Counterpart of ``xclip_tpu/sae/losses.py``: per-item terms over the last
axis, batch means for the scalar loss and its four logged terms.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SAELossCfg:
    l1_coefficient: float = 1e-4
    l2_reduction: str = "mean"  # 'mean' (reference default) or 'sum' over features

    def __post_init__(self):
        if self.l2_reduction not in ("mean", "sum"):
            raise ValueError(f"l2_reduction must be 'mean' or 'sum', got {self.l2_reduction!r}")


def itemwise_losses(cfg: SAELossCfg, source, learned, decoded) -> Dict[str, torch.Tensor]:
    """Per-item loss terms, shapes (batch, [components])."""
    abs_loss = torch.sum(torch.abs(learned), dim=-1)
    l1_penalty = cfg.l1_coefficient * abs_loss
    sq_err = (source - decoded) ** 2
    l2 = torch.mean(sq_err, dim=-1) if cfg.l2_reduction == "mean" else torch.sum(sq_err, dim=-1)
    return {
        "learned_activations_l1_loss": abs_loss,
        "learned_activations_l1_loss_penalty": l1_penalty,
        "l2_reconstruction_loss": l2,
        "total_loss": l1_penalty + l2,
    }


def sae_loss(cfg: SAELossCfg, source, learned, decoded) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar training loss (batch mean of l1_penalty + l2) and the batch
    mean of each term."""
    metrics = {k: torch.mean(v) for k, v in itemwise_losses(cfg, source, learned, decoded).items()}
    return metrics["total_loss"], metrics


def loss_per_item(cfg: SAELossCfg, source, learned, decoded) -> torch.Tensor:
    """Total loss per item: the resampler's importance weights."""
    return itemwise_losses(cfg, source, learned, decoded)["total_loss"]
