"""SAE training and validation metrics.

Counterpart of ``xclip_tpu/sae/metrics.py``: L0 norm, feature density,
capacity (Scherlis et al. 2022), neuron activity and the model
reconstruction score.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def l0_norm(learned_activations: torch.Tensor) -> torch.Tensor:
    """Mean number of firing features per sample."""
    return torch.mean(torch.sum(learned_activations > 0, dim=-1).float())


def feature_density(learned_activations: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Fraction of samples each feature fired in -> ([components,] m)."""
    return torch.mean((learned_activations > threshold).float(), dim=0)


def capacities(features: torch.Tensor) -> torch.Tensor:
    """Per-sample capacity diag(G^2) / rowsum(G^2), G the batch Gram matrix
    of the learned features; ``features`` (batch, [components,] m) ->
    ([components,] batch), the components axis dropped when it is 1."""
    if features.dim() == 2:
        features = features[:, None, :]
    gram = torch.einsum("bcm,dcm->cbd", features, features) ** 2
    caps = torch.diagonal(gram, dim1=1, dim2=2) / torch.sum(gram, dim=-1)
    return caps[0] if caps.shape[0] == 1 else caps


def neuron_activity(learned_activations: torch.Tensor) -> torch.Tensor:
    """Number of times each neuron fired in the batch -> ([components,] m)."""
    return torch.sum(learned_activations > 0, dim=0)


def model_reconstruction_score(source_loss, loss_with_reconstruction, loss_with_zero_ablation) -> Dict[str, float]:
    """(l_zero - l_recon) / (l_zero - l), itemwise mean, in float64."""
    source_loss = np.asarray(source_loss, np.float64)
    recon = np.asarray(loss_with_reconstruction, np.float64)
    zero = np.asarray(loss_with_zero_ablation, np.float64)
    if source_loss.size == 0:
        return {}
    itemwise = (zero - recon) / (zero - source_loss)
    return {
        "source_model_loss": float(source_loss.mean()),
        "source_model_loss_with_reconstruction": float(recon.mean()),
        "source_model_loss_with_zero_ablation": float(zero.mean()),
        "model_reconstruction_score": float(itemwise.mean()),
    }


def train_metrics(source, learned, decoded) -> Dict[str, torch.Tensor]:
    """The default train metric bundle logged per window."""
    return {
        "learned_activations_l0_norm": l0_norm(learned),
        "mean_feature_density": torch.mean(feature_density(learned)),
        "mean_capacity": torch.mean(capacities(learned)),
    }
