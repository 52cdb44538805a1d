"""Training CLI for one GPU: ``python -m xclip_tpu_torch.train.main``.

Counterpart of the one-process path of ``xclip_tpu/train/main.py``
(reference training/main.py and train.py:train_one_epoch): experiment
naming, ``--resume latest``, the model in fp32 with a train-mode forward in
the precision's compute dtype, a TSV/CSV or synthetic dataset behind the
threaded loader, cosine/const schedules, AdamW, per-epoch ``epoch_N.pt``
checkpoints in open_clip's format (plus an atomic ``epoch_latest.pt`` with
``--save-most-recent``), and the reference log line::

    Train Epoch: 0 [256/1024 (25%)] Loss: 5.5452 (5.545) Data (t): 0.012
    Batch (t): 0.431, 594.0/s, 594.0/s/gpu Scale: 14.286

Batches are pinned in the loader's thread and copied to the card with
``non_blocking=True``. Losses are fetched from the device only at log
boundaries. Not ported yet: per-epoch zero-shot evaluation, webdataset,
device prefetch threads, several processes. fp32 products and
convolutions run in full fp32 (no TF32).
"""

from __future__ import annotations

import glob
import logging
import math
import os
import re
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from xclip_tpu_torch.core.checkpoint import load_training_checkpoint, save_checkpoint
from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import SyntheticDataset, TsvDataset
from xclip_tpu_torch.data.loader import DataLoader, tokenizing_collate
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.models.factory import create_model
from xclip_tpu_torch.tokenizer import get_tokenizer
from xclip_tpu_torch.train import optim, schedule
from xclip_tpu_torch.train.params import parse_args
from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step

LATEST_CHECKPOINT_NAME = "epoch_latest.pt"
# precision flag -> the train step's compute policy, as the JAX trainer maps it
_BF16_FLAGS = ("amp", "amp_bf16", "amp_bfloat16", "bf16", "fp16")


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def get_latest_checkpoint(path: str) -> Optional[str]:
    files = glob.glob(os.path.join(path, "**/*.pt"), recursive=True)
    return sorted(files, key=natural_key)[-1] if files else None


def _pinned(collate):
    """Wrap a numpy collate so its batches come out as pinned CPU tensors
    (run in the loader's thread, off the training loop)."""

    def pin(items):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in collate(items).items()}

    return pin


def get_data(args, preprocess_train, tokenizer, pin_memory: bool) -> DataLoader:
    dataset_type = args.dataset_type
    if dataset_type == "auto":
        if not args.train_data:
            raise ValueError("no data: pass --train-data, or --dataset-type synthetic")
        ext = args.train_data.split(".")[-1]
        dataset_type = "csv" if ext in ("csv", "tsv") else "synthetic"
    if dataset_type in ("csv", "tsv"):
        if not args.train_data:
            raise ValueError(f"--dataset-type {dataset_type} needs --train-data")
        ds = TsvDataset(args.train_data, img_transform=preprocess_train)
    else:
        ds = SyntheticDataset(preprocess_train, image_size=preprocess_train.size,
                              dataset_size=args.train_num_samples or 100)
    collate = tokenizing_collate(tokenizer)
    return DataLoader(ds, args.batch_size * args.accum_freq, shuffle=True, seed=args.seed, drop_last=True,
                      num_threads=args.workers, collate=_pinned(collate) if pin_memory else collate)


def _to_device(batch, device: torch.device):
    return [torch.as_tensor(batch[k]).to(device, non_blocking=True) for k in ("images", "texts")]


def train_one_epoch(step_fn, loader: DataLoader, epoch: int, args, device: torch.device) -> None:
    loader.set_epoch(epoch)
    num_batches_per_epoch = loader.num_batches
    sample_digits = math.ceil(math.log10(loader.num_samples + 1))
    losses_m, batch_time_m, data_time_m = AverageMeter(), AverageMeter(), AverageMeter()
    pending = []  # device (loss, logit_scale) of the steps since the last log line
    scale_val = 0.0
    end = time.time()
    for i, batch in enumerate(loader):
        step = num_batches_per_epoch * epoch + i
        data_time_m.update(time.time() - end)
        images, texts = _to_device(batch, device)
        metrics = step_fn(images, texts, step)
        pending.append((metrics["loss"], metrics["logit_scale"]))
        batch_count = i + 1
        logging_now = batch_count % args.log_every_n_steps == 0 or batch_count == num_batches_per_epoch
        if logging_now:  # the one host sync of the window
            for loss, scale in pending:
                losses_m.update(float(loss), n=args.batch_size)
            scale_val = float(pending[-1][1])
            pending.clear()
        batch_time_m.update(time.time() - end)
        end = time.time()
        if logging_now:
            num_samples = batch_count * args.batch_size * args.accum_freq
            percent_complete = 100.0 * batch_count / num_batches_per_epoch
            samples_per_second = args.accum_freq * args.batch_size / batch_time_m.avg
            logging.info(
                f"Train Epoch: {epoch} [{num_samples:>{sample_digits}}/{loader.num_samples} "
                f"({percent_complete:.0f}%)] "
                f"Loss: {losses_m.val:#.5g} ({losses_m.avg:#.4g}) "
                f"Data (t): {data_time_m.avg:.3f} "
                f"Batch (t): {batch_time_m.avg:.3f}, {samples_per_second:#g}/s, "
                f"{samples_per_second:#g}/s/gpu "
                f"Scale: {scale_val:.3f}"
            )
            batch_time_m.reset()
            data_time_m.reset()
    for loss, _ in pending:  # a loader shorter than num_batches: keep every loss
        losses_m.update(float(loss), n=args.batch_size)


def _setup_logging(log_file: str):
    """File and console handlers on the root logger; returns them for removal."""
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s", datefmt="%Y-%m-%d,%H:%M:%S")
    handlers = [logging.FileHandler(log_file), logging.StreamHandler()]
    root = logging.getLogger()
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)
    root.setLevel(logging.INFO)
    return handlers


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    if args.name is None:
        date_str = datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
        args.name = "-".join([date_str, f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}",
                              f"b_{args.batch_size}", f"j_{args.workers}", f"p_{args.precision}"])
    resume_latest = args.resume == "latest"
    log_base_path = os.path.join(args.logs, args.name)
    os.makedirs(log_base_path, exist_ok=True)
    log_path = os.path.join(log_base_path, "out.log")
    if os.path.exists(log_path) and not resume_latest:
        print(f"Error. Experiment already exists. Use --name {args.name}-new to specify a new experiment.")
        return -1
    handlers = _setup_logging(log_path)
    try:
        return _train(args, device, log_base_path, resume_latest)
    finally:
        for h in handlers:
            logging.getLogger().removeHandler(h)
            h.close()


def _train(args, device: torch.device, log_base_path: str, resume_latest: bool) -> int:
    checkpoint_path = os.path.join(log_base_path, "checkpoints")
    os.makedirs(checkpoint_path, exist_ok=True)
    if resume_latest:
        args.resume = get_latest_checkpoint(checkpoint_path)
        logging.info(f"Found latest resume checkpoint at {args.resume}." if args.resume
                     else f"No latest resume checkpoint found in {checkpoint_path}.")
    logging.info(f"Running on {device}"
                 + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                 + "; 1 process.")

    model = create_model(args.model, precision="fp32", device=device, seed=args.seed).train()
    preprocess_train = image_transform(model.cfg.image_size, is_train=True, seed=args.seed)
    loader = get_data(args, preprocess_train, get_tokenizer(args.model), pin_memory=device.type == "cuda")

    total_steps = loader.num_batches * args.epochs
    cooldown = {}
    if args.lr_scheduler == "const-cooldown":
        cooldown = dict(cooldown_steps=loader.num_batches * (args.epochs_cooldown or 0),
                        cooldown_power=args.lr_cooldown_power, cooldown_end_lr=args.lr_cooldown_end)
    sched = schedule.get_scheduler(args.lr_scheduler, args.lr, args.warmup, total_steps, **cooldown)
    optimizer = optim.adamw(model, lr=args.lr, beta1=args.beta1, beta2=args.beta2, eps=args.eps,
                            weight_decay=args.wd)
    step_cfg = TrainStepCfg(
        precision="bf16" if args.precision in _BF16_FLAGS else "fp32",
        grad_checkpointing=args.grad_checkpointing,
        accum_freq=args.accum_freq,
        grad_clip_norm=args.grad_clip_norm or 0.0,
    )
    step_fn = make_train_step(model, optimizer, sched, step_cfg)

    start_epoch = 0
    if args.resume:
        extras = load_training_checkpoint(args.resume, model, optimizer)
        if isinstance(extras.get("epoch"), int):
            start_epoch = extras["epoch"]  # epoch_latest.pt carries no number in its name
        else:
            m = re.search(r"epoch_(\d+)", os.path.basename(args.resume))
            start_epoch = int(m.group(1)) if m else 0
        logging.info(f"=> resuming checkpoint '{args.resume}' (epoch {start_epoch})")

    for epoch in range(start_epoch, args.epochs):
        logging.info(f"Start epoch {epoch}")
        train_one_epoch(step_fn, loader, epoch, args, device)
        completed_epoch = epoch + 1
        if completed_epoch == args.epochs or (
                args.save_frequency > 0 and completed_epoch % args.save_frequency == 0):
            for name in [f"epoch_{completed_epoch}.pt"] + [LATEST_CHECKPOINT_NAME] * args.save_most_recent:
                save_checkpoint(os.path.join(checkpoint_path, name), model, optimizer,
                                epoch=completed_epoch, name=args.name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
