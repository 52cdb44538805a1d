"""AdamW and Nesterov SGD with the reference's weight-decay grouping, and
global-norm clipping.

Counterpart of ``xclip_tpu/train/optim.py`` (``wd_mask``, ``adamw``;
reference training/main.py:311-326): parameters with ndim < 2, or whose
open_clip name contains ``bn``, ``ln``, ``bias`` or ``logit_scale``, get no
weight decay. ``torch.optim.AdamW`` with two parameter groups takes the
place of ``optax.adamw(mask=wd_mask)``; its decoupled decay is the same
update. ``torch.optim.SGD(nesterov=True)`` over the same two groups takes
the place of the supervised baseline's ``optax.chain(add_decayed_weights(wd,
mask=wd_mask), sgd(momentum, nesterov=True))`` (``learner.py:95-99``):
both add ``wd * p`` to the gradient, keep ``t = g + m t`` and step by
``g + m t``. Clipping follows ``optax.clip_by_global_norm``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch
from torch import nn


def decays(name: str, param: torch.Tensor) -> bool:
    """True where weight decay applies (the reference exclude rule inverted)."""
    excluded = (param.ndim < 2 or "bn" in name or "ln" in name or "bias" in name
                or "logit_scale" in name)
    return not excluded


def wd_mask(model: nn.Module) -> Dict[str, bool]:
    return {name: decays(name, p) for name, p in model.named_parameters()}


def _groups(model: nn.Module, weight_decay: float) -> List[dict]:
    """The trainable parameters in two groups: not decayed, then decayed."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return [
        {"params": [p for n, p in named if not decays(n, p)], "weight_decay": 0.0},
        {"params": [p for n, p in named if decays(n, p)], "weight_decay": weight_decay},
    ]


def adamw(model: nn.Module, *, lr: float, beta1: float = 0.9, beta2: float = 0.98, eps: float = 1e-6,
          weight_decay: float = 0.2) -> torch.optim.AdamW:
    """AdamW over two groups: decayed (``weight_decay``) and not (0). The
    learning rate is set per step by the train step from its schedule."""
    return torch.optim.AdamW(_groups(model, weight_decay), lr=lr, betas=(beta1, beta2), eps=eps)


def sgd_nesterov(model: nn.Module, *, lr: float, momentum: float = 0.9, weight_decay: float = 1e-4
                 ) -> torch.optim.SGD:
    """Nesterov SGD over two groups: decayed (``weight_decay``) and not (0).
    The learning rate is set per step by the train step from its schedule."""
    return torch.optim.SGD(_groups(model, weight_decay), lr=lr, momentum=momentum, nesterov=True)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32 (optax.global_norm)."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> None:
    """``optax.clip_by_global_norm``, in place: gradients are left as they
    are when ``norm < max_norm``, else become ``g / norm * max_norm``. Runs on
    the device with no host sync."""
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
