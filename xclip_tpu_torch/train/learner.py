"""The supervised classifier baseline: a CLIP image tower, ReLU and a
linear head over the 1345-way CombinedNet label space.

Counterpart of ``xclip_tpu/train/learner.py`` (reference xclip/learner.py:
the Lightning ``ImageNetCaptionsLearner``):

- :class:`ClassifierCfg` and :class:`Classifier` (:33-88): the port's
  ModifiedResNet or ViT tower (``rn50-clip`` -> RN50, ``vit-b-32-clip`` and
  ``vit-b-32-timm`` -> ViT-B-32), ReLU, then the head as an fp32 product
  on the fp32-cast features; random init from a seed (the JAX init's
  distributions, not its numbers);
- :func:`make_classifier_train_step` (:90-140): cross-entropy as
  logsumexp minus the picked logit, accuracy, Nesterov SGD (momentum 0.9,
  weight decay 1e-4 by ``optim.decays``) at optax's per-step
  ``piecewise_constant`` schedule (``lr`` scaled by ``gamma`` from step
  ``m * steps_per_epoch`` on, for each milestone ``m``), counted from 0 by
  the step itself as optax counts in its state. BatchNorm runs in train
  mode; the new running statistics are applied once per step. With a
  process group the loss, accuracy, gradients and running statistics are
  averaged over the ranks, as the JAX step's ``pmean``s do;
- :func:`make_classifier_eval_step` (:142-173), forward only, in eval mode;
- :func:`save_classifier` / :func:`load_classifier` (:176-187): the JAX
  package's native ``.npz`` with the JAX classifier's pytree paths, so a
  checkpoint written by either package loads in the other;
- :func:`classifier_predictions` (:190-215): batched argmax predictions,
  ``logit_slice`` selecting a label range first; the ragged last batch is
  not padded (the kernels take a ragged row count).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xclip_tpu_torch.core.checkpoint import (
    classifier_pytrees_from_state_dict,
    classifier_state_dict_from_pytrees,
    load_native,
    save_native,
    unflatten_into,
)
from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import get_policy
from xclip_tpu_torch.data.loader import DataLoader
from xclip_tpu_torch.models import layers as L
from xclip_tpu_torch.models.factory import get_clip_cfg
from xclip_tpu_torch.models.resnet import ModifiedResNet, Moments, apply_bn_moments
from xclip_tpu_torch.models.transformer import VisionTransformer
from xclip_tpu_torch.parallel.distributed import all_reduce_mean_
from xclip_tpu_torch.train.optim import sgd_nesterov
from xclip_tpu_torch.train.schedule import piecewise_constant
from xclip_tpu_torch.train.step import normalize_images

MODELS = ("rn50-clip", "vit-b-32-clip", "vit-b-32-timm")


@dataclasses.dataclass(frozen=True)
class ClassifierCfg:
    model: str = "rn50-clip"
    num_classes: int = 1345
    lr: float = 0.1
    milestones: Tuple[int, ...] = (30, 50, 70)
    gamma: float = 0.1

    @property
    def backbone_name(self) -> str:
        return {"rn50-clip": "RN50", "vit-b-32-clip": "ViT-B-32", "vit-b-32-timm": "ViT-B-32"}[self.model]

    @property
    def feature_dim(self) -> int:
        return 1024 if self.model == "rn50-clip" else 512


class Classifier(nn.Module):
    """Image tower (``visual.*``, open_clip names) + ReLU + ``head``."""

    def __init__(self, cfg: ClassifierCfg):
        super().__init__()
        self.cfg = cfg
        self.clip_cfg = get_clip_cfg(cfg.backbone_name)
        vision = self.clip_cfg.vision
        self.visual = ModifiedResNet(vision) if self.clip_cfg.is_resnet else VisionTransformer(vision)
        self.head = nn.Linear(cfg.feature_dim, cfg.num_classes)

    @property
    def image_size(self) -> int:
        return self.clip_cfg.image_size

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """The tower's random init, then the head as ``layers.linear_init``
        does: U(-1/sqrt(in), 1/sqrt(in)) weights, zero bias."""
        self.visual.init_parameters(generator)
        L.uniform_(self.head.weight, self.cfg.feature_dim ** -0.5, generator)
        self.head.bias.zero_()

    def forward(self, images: torch.Tensor, dtype: Optional[torch.dtype] = None, *,
                moments: Optional[Moments] = None) -> torch.Tensor:
        """images: (N, H, W, 3) NHWC float -> (N, num_classes) fp32 logits.
        In train mode ``moments`` receives a ResNet's new BatchNorm running
        statistics (``ModifiedResNet.forward``)."""
        if self.clip_cfg.is_resnet:
            feats = self.visual(images, dtype=dtype, moments=moments)
        else:
            feats = self.visual(images, dtype=dtype)
        return F.linear(torch.relu(feats).float(), self.head.weight.float(), self.head.bias.float())


def create_classifier(cfg: ClassifierCfg, device: Union[str, torch.device] = "cuda", seed: int = 0) -> Classifier:
    """``cfg``'s classifier in fp32 and eval mode on ``device`` (CUDA by
    default, which must be present; ``"cpu"`` for the CPU), weights from
    ``torch.Generator().manual_seed(seed)`` on the CPU."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Classifier(cfg)
    model = model.to_empty(device="cpu")
    model.init_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def _loss_and_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    labels = labels.long()
    picked = logits.gather(1, labels[:, None])[:, 0]
    loss = (torch.logsumexp(logits, dim=-1) - picked).mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, acc


def make_classifier_train_step(model: Classifier, *, steps_per_epoch: int, precision: str = "bf16",
                               group=None) -> Tuple[Callable, torch.optim.Optimizer]:
    """``(step, optimizer)``: ``step(images, labels) -> {"loss", "accuracy"}``
    (device tensors, no host sync) updates ``model`` in place. ``images``:
    (B, H, W, 3) uint8 or normalized float, ``labels``: (B,) ints, both on
    the model's device; the rank's rows when ``group`` is a process group.
    The model must be in train mode."""
    cfg = model.cfg
    dtype = get_policy(precision).compute_dtype
    schedule = piecewise_constant(cfg.lr, {int(m * steps_per_epoch): cfg.gamma for m in cfg.milestones})
    optimizer = sgd_nesterov(model, lr=cfg.lr, momentum=0.9, weight_decay=1e-4)
    params = [p for p in model.parameters() if p.requires_grad]
    bn_stats = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    count = [0]  # optimizer steps taken: optax's count, which starts at 0 with the optimizer

    def step(images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        moments: Moments = {}
        logits = model(normalize_images(images), dtype, moments=moments)
        loss, acc = _loss_and_accuracy(logits, labels)
        loss.backward()
        apply_bn_moments(model.visual, moments)  # a ViT fills no moments
        metrics = torch.stack([loss.detach(), acc])
        if group is not None:  # the JAX step's pmeans
            all_reduce_mean_([metrics], group)
            all_reduce_mean_([p.grad for p in params], group)
            if bn_stats:
                all_reduce_mean_(bn_stats, group)
        lr = schedule(count[0])
        for param_group in optimizer.param_groups:
            param_group["lr"] = lr
        optimizer.step()
        count[0] += 1
        return {"loss": metrics[0], "accuracy": metrics[1]}

    return step, optimizer


def make_classifier_eval_step(model: Classifier, *, precision: str = "bf16", group=None) -> Callable:
    """``eval_step(images, labels) -> {"val_loss", "val_accuracy"}``: an
    eval-mode forward (running BatchNorm statistics), averaged over the
    ranks of ``group``; the model's mode is restored after."""
    dtype = get_policy(precision).compute_dtype

    def eval_step(images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                loss, acc = _loss_and_accuracy(model(normalize_images(images), dtype), labels)
                metrics = torch.stack([loss, acc])
        finally:
            model.train(was_training)
        if group is not None:
            metrics = metrics.clone()
            all_reduce_mean_([metrics], group)
        return {"val_loss": metrics[0], "val_accuracy": metrics[1]}

    return eval_step


def save_classifier(path: str, model: Classifier, extras: Optional[dict] = None) -> None:
    """``model``'s weights as JAX's ``save_classifier`` writes them."""
    params, state = classifier_pytrees_from_state_dict(model.state_dict(), model.clip_cfg)
    save_native(path, params, state, extras=extras or {})


def load_classifier(path: str, model: Classifier) -> dict:
    """Load a native classifier checkpoint (written by either package) into
    ``model`` in place; returns its extras. Every pytree path of the
    model must be in the file with its shape, as JAX's ``load_native``
    demands."""
    pflat, sflat, extras = load_native(path)
    params, state = classifier_pytrees_from_state_dict(model.state_dict(), model.clip_cfg)
    params = unflatten_into(params, pflat)
    state = unflatten_into(state, sflat) if sflat else state
    sd = classifier_state_dict_from_pytrees(params, state, model.clip_cfg)
    model.load_state_dict(sd, strict=True)
    return extras


@torch.no_grad()
def classifier_predictions(model: Classifier, dataset, *, batch_size: int = 250, num_threads: int = 8,
                           logit_slice: Optional[Tuple[int, int]] = None) -> Dict[str, np.ndarray]:
    """Argmax predictions of ``model`` (eval mode, fp32) over ``dataset``'s
    (image, label) samples: ``{"pred", "labels"}``. ``logit_slice`` keeps
    ``logits[:, lo:hi]`` before the argmax (the supervised LSO protocol
    takes the DomainNet range 1000:1345)."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    preds, labels = [], []
    try:
        for images, lab in DataLoader(dataset, batch_size, num_threads=num_threads):
            logits = model(torch.from_numpy(np.ascontiguousarray(images)).to(device))
            if logit_slice is not None:
                logits = logits[:, logit_slice[0]:logit_slice[1]]
            preds.append(logits.argmax(dim=-1).cpu().numpy())
            labels.append(np.asarray(lab))
    finally:
        model.train(was_training)
    return {"pred": np.concatenate(preds), "labels": np.concatenate(labels)}
