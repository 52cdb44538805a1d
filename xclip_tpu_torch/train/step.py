"""The training step: forward, loss, backward, clip, AdamW.

Counterpart of ``xclip_tpu/train/step.py:make_train_step`` (reference
training/train.py:64-264). PyTorch runs eagerly and updates in place: the
step changes the model's parameters and BatchNorm buffers and the
optimizer's state, and returns the metrics as device tensors (no host
sync). With a ``group`` each process is one data-parallel rank holding its
own rows of the batch:

- the loss gathers every rank's features into the local row block with
  the differentiable gather (``train.loss.clip_loss``'s defaults, the
  layout the JAX trainer always uses, train/main.py:505-510);
- after the last microbatch, all-reduces average the loss metric, the
  gradients (one flattened buffer) and, for a ResNet, the BatchNorm running
  statistics over the ranks, as ``jax.lax.pmean`` does at step.py:263-266;
  BatchNorm itself uses each rank's batch statistics (no sync BN), and
  ``num_batches_tracked`` is equal on every rank. A ViT has no running
  statistics; a frozen parameter (``requires_grad=False``, the sin-cos
  positional embedding) is neither averaged nor updated;
- there is no ``DistributedDataParallel`` wrapper: the reduction is
  explicit, so it holds exactly to ``pmean`` across the accumulation loop
  and the per-block recomputation.

- uint8 images are normalized on the device in fp32 (``normalize_images``);
- the towers run in the precision policy's compute dtype, with explicit
  casts (no autocast) and per-block recomputation under
  ``grad_checkpointing``;
- with ``accum_freq > 1`` the step runs the reference's cached-negatives
  accumulation (step.py:220-261): a no-grad train-mode forward caches every
  microbatch's features (its BatchNorm statistics are thrown away), then
  each microbatch is re-forwarded with grad against the cached others; the
  microbatch gradients are summed, not averaged, and the running statistics
  advance once per microbatch, in order;
- a ViT with patch dropout draws its kept patches from a generator seeded
  per (seed, step, rank, microbatch), as JAX folds its rng (step.py:132-140):
  the caching forward and the re-forward of a microbatch keep the same
  patches, and per-block recomputation draws nothing;
- the global gradient norm is taken after the averaging and before clipping, clipping is optax's,
  the learning rate comes from the schedule at the 0-based step, and the
  log logit scale is clamped to [0, ln 100] after the update.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from xclip_tpu_torch.core.precision import get_policy
from xclip_tpu_torch.data.transforms import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from xclip_tpu_torch.models.resnet import apply_bn_moments
from xclip_tpu_torch.parallel.distributed import all_reduce_mean_
from xclip_tpu_torch.train.loss import clip_loss
from xclip_tpu_torch.train.optim import clip_by_global_norm_, global_norm

LOG_LOGIT_SCALE_MAX = math.log(100.0)


@dataclasses.dataclass(frozen=True)
class TrainStepCfg:
    precision: str = "amp"
    grad_checkpointing: bool = False
    accum_freq: int = 1
    grad_clip_norm: float = 0.0  # 0 = no clipping
    seed: int = 0  # of the patch-dropout draws


def dropout_seed(seed: int, step_idx: int, rank: int, micro: int) -> int:
    """A 63-bit generator seed for one (seed, step, rank, microbatch)."""
    digest = hashlib.blake2b(f"{seed},{step_idx},{rank},{micro}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC batches -> ``(v/255 - mean)/std`` with the OpenAI CLIP
    mean/std, in fp32 on their device; float batches pass through."""
    if images.dtype.is_floating_point:
        return images
    mean = torch.tensor(OPENAI_DATASET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(OPENAI_DATASET_STD, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - mean) / std


def make_train_step(model, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                    cfg: TrainStepCfg = TrainStepCfg(), group=None):
    """``step(images, texts, step_idx) -> {"loss", "grad_norm", "logit_scale"}``.

    ``images``: (accum*B, H, W, 3) uint8 or float; ``texts``: (accum*B, L)
    token ids; both on the model's device, the rank's rows when ``group``
    is a process group (every rank then calls the step with equal shapes).
    ``step_idx`` is the 0-based optimizer step the schedule is evaluated
    at. The model must be in train mode.
    """
    dtype = get_policy(cfg.precision).compute_dtype
    accum = cfg.accum_freq
    params = [p for p in model.parameters() if p.requires_grad]
    bn_stats = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    rank = dist.get_rank(group) if group is not None else 0
    dropout = getattr(model.cfg.vision, "patch_dropout", 0.0) > 0.0

    def forward(images, texts, moments, generator):
        return model(normalize_images(images), texts, dtype, moments=moments, generator=generator,
                     grad_checkpointing=cfg.grad_checkpointing)

    def forward_backward(images, texts, step_idx) -> torch.Tensor:
        b = images.shape[0] // accum
        chunks = list(zip(images.split(b), texts.split(b)))

        def generator(j) -> Optional[torch.Generator]:
            if not dropout:
                return None
            return torch.Generator(device=images.device).manual_seed(dropout_seed(cfg.seed, step_idx, rank, j))

        cached = []
        if accum > 1:  # phase 1: every microbatch's features, no grad
            with torch.no_grad():
                cached = [forward(imgs, txts, None, generator(j))[:2] for j, (imgs, txts) in enumerate(chunks)]
        loss_sum = torch.zeros((), device=images.device)
        for j, (imgs, txts) in enumerate(chunks):
            moments: Dict = {}
            img_j, txt_j, scale = forward(imgs, txts, moments, generator(j))
            if cached:  # phase 2: microbatch j against the cached others
                img_j = torch.cat([img_j if i == j else c[0] for i, c in enumerate(cached)])
                txt_j = torch.cat([txt_j if i == j else c[1] for i, c in enumerate(cached)])
            loss_j = clip_loss(img_j, txt_j, scale, group)
            loss_j.backward()  # gradients add up in .grad: summed over microbatches
            apply_bn_moments(model.visual, moments)  # a ViT fills no moments
            loss_sum += loss_j.detach()
        return loss_sum / accum

    def step(images: torch.Tensor, texts: torch.Tensor, step_idx: int) -> Dict[str, torch.Tensor]:
        if images.shape[0] % accum:
            raise ValueError(f"batch of {images.shape[0]} does not split into {accum} microbatches")
        optimizer.zero_grad(set_to_none=True)
        loss = forward_backward(images, texts, step_idx)
        grads = [p.grad for p in params if p.grad is not None]
        if group is not None:  # pmean of the loss, the gradients and the BatchNorm state
            all_reduce_mean_([loss], group)
            all_reduce_mean_(grads, group)
            if bn_stats:
                all_reduce_mean_(bn_stats, group)
        grad_norm = global_norm(grads)
        if cfg.grad_clip_norm and cfg.grad_clip_norm > 0:
            clip_by_global_norm_(grads, grad_norm, cfg.grad_clip_norm)
        lr = schedule(step_idx)
        for param_group in optimizer.param_groups:
            param_group["lr"] = lr
        optimizer.step()
        with torch.no_grad():
            model.logit_scale.clamp_(0.0, LOG_LOGIT_SCALE_MAX)
        return {"loss": loss, "grad_norm": grad_norm, "logit_scale": model.logit_scale.detach().exp()}

    return step
