"""Supervised 1345-way classifier training on CombinedNet.

Counterpart of ``scripts/train_combined_captions.py`` (reference: the same
script through Lightning), with its flags, plus ``--device``::

    python -m xclip_tpu_torch.scripts.train_combined_captions --model rn50-clip \\
        --train_index_path train.tsv --val_index_path val.tsv \\
        --in_class_index_path data/imagenet_class_index.json \\
        --class_mapping_path data/in_to_dn_mapping.json \\
        --experiment_name supervised --batch_size 256 --max_epochs 90

- ``--batch_size`` is global: under ``torchrun --nproc_per_node N`` each
  rank takes ``batch_size // N`` rows of its shard of every epoch's seeded
  permutation; loss, accuracy, gradients and BatchNorm statistics are
  averaged over the ranks (``train.learner``). One process needs no
  launcher.
- ``--precision``: any value holding ``16`` (the default ``16-mixed``)
  computes in bf16 with no loss scaler, anything else in fp32, as the JAX
  script maps it. The Lightning flags ``--accelerator``, ``--strategy``,
  ``--devices``, ``--num_nodes`` and ``--gradient_clip_val`` are accepted
  and ignored, as there; ``--detect_anomaly`` turns on
  ``torch.autograd.set_detect_anomaly`` for the run.
- Checkpoints, in the JAX package's native ``.npz`` under
  ``<ws_path>/checkpoints/<experiment_name>/``: ``epoch=0-step=0.npz``
  before the first step (written again on a resume), ``epoch={n}.npz``
  every ``--save_epochs`` epochs and at the end, ``last.npz`` after every
  epoch; rank 0 writes them.
- ``--ckpt_path`` resumes the weights and the epoch only: the optimizer
  starts afresh (no momentum, the learning-rate schedule from step 0), as
  the JAX script does.
- Every 50 steps a log line ``epoch E step S loss L acc A (R img/s)``; after
  each epoch a forward-only validation pass over the val TSV in full
  batches, logged as the mean of the per-batch means.

The device defaults to CUDA and must be present unless ``--device cpu`` is
given. fp32 products and convolutions run in full fp32 (no TF32).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import CombinedNet
from xclip_tpu_torch.data.loader import DataLoader
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.parallel.distributed import DistInfo, broadcast_model, init_distributed_from_env
from xclip_tpu_torch.train.learner import (
    MODELS,
    ClassifierCfg,
    create_classifier,
    load_classifier,
    make_classifier_eval_step,
    make_classifier_train_step,
    save_classifier,
)
from xclip_tpu_torch.utils.meters import AverageMeter, setup_logging


def collate(items, pin: bool = False):
    """(image, label) samples -> ``{"images": uint8 NHWC, "labels": int32}``
    tensors, pinned when ``pin``."""
    out = {"images": torch.from_numpy(np.stack([np.asarray(it[0]) for it in items])),
           "labels": torch.from_numpy(np.asarray([it[1] for it in items], np.int32))}
    return {k: v.pin_memory() for k, v in out.items()} if pin else out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Supervised CombinedNet classifier (PyTorch/CUDA port).")
    parser.add_argument("--model", type=str, default="rn50-clip", choices=list(MODELS))
    parser.add_argument("--train_index_path", type=str, required=True)
    parser.add_argument("--val_index_path", type=str, required=True)
    parser.add_argument("--in_class_index_path", type=str, required=True)
    parser.add_argument("--class_mapping_path", type=str, required=True)
    parser.add_argument("--experiment_name", type=str, required=True)
    parser.add_argument("--learning_rate", type=float, default=0.1)
    parser.add_argument("--batch_size", type=int, default=256, help="global batch size")
    parser.add_argument("--num_workers", type=int, default=32)
    parser.add_argument("--max_epochs", type=int, default=90)
    parser.add_argument("--save_epochs", type=int, default=5)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--ckpt_path", type=str, default=None)
    parser.add_argument("--ws_path", type=str, default=None)
    # Lightning's flags, accepted and ignored as the JAX script does
    parser.add_argument("--accelerator", type=str, default="auto")
    parser.add_argument("--strategy", type=str, default="auto")
    parser.add_argument("--devices", type=int, default=-1)
    parser.add_argument("--num_nodes", type=int, default=1)
    parser.add_argument("--precision", type=str, default="16-mixed")
    parser.add_argument("--gradient_clip_val", type=float, default=None)
    parser.add_argument("--detect_anomaly", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def train(args, device: torch.device, group) -> None:
    info = DistInfo.current()
    if args.batch_size % info.world_size:
        raise ValueError(f"--batch_size {args.batch_size} does not split over {info.world_size} ranks")
    local_batch = args.batch_size // info.world_size
    model = create_classifier(ClassifierCfg(model=args.model, num_classes=1345, lr=args.learning_rate),
                              device=device, seed=args.seed or 0).train()

    train_ds = CombinedNet(args.train_index_path, args.in_class_index_path, args.class_mapping_path,
                           transform=image_transform(model.image_size, is_train=True))
    val_ds = CombinedNet(args.val_index_path, args.in_class_index_path, args.class_mapping_path,
                         transform=image_transform(model.image_size, is_train=False))
    pin = device.type == "cuda"
    loader_kw = dict(num_threads=args.num_workers or 8, collate=lambda items: collate(items, pin),
                     rank=info.rank, world_size=info.world_size)
    train_loader = DataLoader(train_ds, local_batch, shuffle=True, drop_last=True, **loader_kw)
    val_loader = DataLoader(val_ds, local_batch, drop_last=True, **loader_kw)

    precision = "bf16" if "16" in str(args.precision) else "fp32"
    step, _ = make_classifier_train_step(model, steps_per_epoch=train_loader.num_batches, precision=precision,
                                         group=group)
    eval_step = make_classifier_eval_step(model, precision=precision, group=group)

    ckpt_dir = os.path.join(args.ws_path or ".", "checkpoints", args.experiment_name)
    if info.is_master:
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(name: str, epoch: int) -> None:
        if info.is_master:
            save_classifier(os.path.join(ckpt_dir, name), model, {"epoch": epoch})

    start_epoch = 0
    if args.ckpt_path:
        start_epoch = int(load_classifier(args.ckpt_path, model).get("epoch", 0))
    if group is not None:
        broadcast_model(model, group)
    save("epoch=0-step=0.npz", 0)  # save-first, as the reference's checkpoint callback

    def to_device(batch):
        return (batch["images"].to(device, non_blocking=True), batch["labels"].to(device, non_blocking=True))

    for epoch in range(start_epoch, args.max_epochs):
        train_loader.set_epoch(epoch)
        loss_m, acc_m = AverageMeter(), AverageMeter()
        t0 = time.time()
        for i, batch in enumerate(train_loader):
            metrics = step(*to_device(batch))
            if i % 50 == 0:
                loss_m.update(float(metrics["loss"]))
                acc_m.update(float(metrics["accuracy"]))
                logging.info("epoch %d step %d loss %.4f acc %.4f (%.1f img/s)", epoch, i, loss_m.val, acc_m.val,
                             args.batch_size * (i + 1) / (time.time() - t0))
        completed = epoch + 1
        if completed % args.save_epochs == 0 or completed == args.max_epochs:
            save(f"epoch={completed}.npz", completed)
        save("last.npz", completed)

        v_loss, v_acc, n = 0.0, 0.0, 0
        for batch in val_loader:
            metrics = eval_step(*to_device(batch))
            v_loss += float(metrics["val_loss"])
            v_acc += float(metrics["val_accuracy"])
            n += 1
        if n:
            logging.info("epoch %d done: val_loss %.4f val_acc %.4f", completed, v_loss / n, v_acc / n)
        else:
            logging.info("epoch %d done", completed)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    handlers = setup_logging(None)
    owns_group = not dist.is_initialized()
    if owns_group:
        init_distributed_from_env(None, device)
    anomaly = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(anomaly or args.detect_anomaly)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        train(args, device, dist.group.WORLD if dist.is_initialized() else None)
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
        for h in handlers:
            logging.root.removeHandler(h)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
