"""Training CLI: ``python -m xclip_tpu_torch.train.main``, one process per
GPU (``torchrun --nproc_per_node N python -m xclip_tpu_torch.train.main``
for several).

Counterpart of the data-parallel path of ``xclip_tpu/train/main.py``
(:56-305, :323-698; reference training/main.py and
train.py:train_one_epoch):

- the launcher's environment starts the process group
  (``parallel.distributed.init_distributed_from_env``; a group that already
  exists is used as it is); rank 0 picks the date-based run name and
  broadcasts it;
- experiment naming, ``--resume latest``, the model (an RN or plain ViT
  config, with ``--force-image-size``/``--force-patch-dropout`` applied) in
  fp32 with a train-mode forward in the precision's compute dtype, its
  parameters and buffers broadcast from rank 0 after creation and resume;
- a TSV/CSV or synthetic dataset behind the threaded loader, sharded over
  the ranks, ``batch_size * accum_freq`` rows per rank and step, every
  rank the same number of steps; batches are pinned in the loader's thread
  and copied to the card with ``non_blocking=True``; or tar shards
  (``--dataset-type webdataset``, or a ``.tar`` name) streamed by
  ``data.wds.WdsLoader`` at the same per-rank batch, the shards split by
  rank (or resampled, ``--dataset-resampled``, with
  ``--train-data-upsampling-factors`` per ``::`` source), the captions from
  ``.txt`` or, with ``--json-captions``, the ``.json`` sidecars, and
  ``--train-num-samples // world_size`` samples a rank and epoch;
- cosine/const schedules, AdamW, the train step with the local-loss row
  block, the differentiable gather and the gradients and BatchNorm
  statistics averaged over the ranks (``train.step``);
- after each epoch (or once, with no train data) the zero-shot ImageNet
  eval (``--imagenet-val``, ``--imagenet-v2``) and the val loss and
  retrieval metrics (``--val-data``) on rank 0 (``train.evaluate``),
  appended to ``checkpoints/results.jsonl``;
- per-epoch ``epoch_N.pt`` checkpoints in open_clip's format (plus an
  atomic ``epoch_latest.pt`` with ``--save-most-recent``), and the
  reference log line::

    Train Epoch: 0 [256/1024 (25%)] Loss: 5.5452 (5.545) Data (t): 0.012
    Batch (t): 0.431, 1188.0/s, 594.0/s/gpu Scale: 14.286

  with samples and ``/s`` counted over all ranks and ``/s/gpu`` per rank;
- ``--report-to tensorboard`` / ``wandb`` / ``all``: rank 0 writes each log
  step's six train scalars (``train/loss``, ``train/logit_scale``,
  ``train/samples_per_second``, ``train/samples_per_second_per_gpu``,
  ``train/data_time``, ``train/batch_time``) to a ``SummaryWriter`` under
  ``<logs>/<name>/tensorboard`` (a warning and no writer when tensorboard
  does not import, as in JAX, main.py:365-373) and to the wandb run
  (``utils.wandb_logger``; offline files without the package), which also
  gets the ``val/*`` metrics of each evaluation (main.py:637-640,664-666).

Rank 0 alone writes: the log file (after the "Experiment already exists"
check, whose outcome every rank follows), the checkpoints and
``results.jsonl``, as the reference's ``is_master`` does. Losses are
fetched from the device only at log boundaries. fp32 products and
convolutions run in full fp32 (no TF32). Not ported: ``--lock-*``,
distillation, and the JAX trainer's ``--batch-prefetch`` device-copy
thread.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import re
import time
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from xclip_tpu_torch.core.checkpoint import load_training_checkpoint, save_checkpoint
from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import ImageNet, ImageNetV2, SyntheticDataset, TsvDataset
from xclip_tpu_torch.data.loader import DataLoader, tokenizing_collate
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.data.wds import WdsLoader, WebDatasetReader
from xclip_tpu_torch.models.factory import create_model
from xclip_tpu_torch.parallel.distributed import (DistInfo, broadcast_model, broadcast_object,
                                                  init_distributed_from_env)
from xclip_tpu_torch.tokenizer import get_tokenizer
from xclip_tpu_torch.train import optim, schedule
from xclip_tpu_torch.train.evaluate import evaluate
from xclip_tpu_torch.train.params import parse_args
from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step
from xclip_tpu_torch.utils.meters import AverageMeter
from xclip_tpu_torch.utils.wandb_logger import init_wandb

LATEST_CHECKPOINT_NAME = "epoch_latest.pt"
# precision flag -> the train step's compute policy, as the JAX trainer maps it
_BF16_FLAGS = ("amp", "amp_bf16", "amp_bfloat16", "bf16", "fp16")


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


EVAL_SPLITS = ("val", "imagenet-val", "imagenet-v2")


def get_data(args, preprocess_train, preprocess_val, tokenizer, pin_memory: bool, info: DistInfo) -> Dict:
    """The loaders of this run: ``train`` (this rank's shard), and ``val``,
    ``imagenet-val``, ``imagenet-v2`` when their flags are given."""
    data = {}
    collate = tokenizing_collate(tokenizer)
    dataset_type = args.dataset_type
    if dataset_type == "auto" and args.train_data:
        ext = args.train_data.split(".")[-1]
        dataset_type = {"tar": "webdataset", "csv": "csv", "tsv": "csv"}.get(ext, "synthetic")
    if dataset_type in ("csv", "tsv", "webdataset") and not args.train_data:
        raise ValueError(f"--dataset-type {dataset_type} needs --train-data")
    train_ds = None
    if dataset_type == "webdataset":
        weights = None
        if args.train_data_upsampling_factors:
            if not args.dataset_resampled:
                raise ValueError("--train-data-upsampling-factors is only supported when sampling with "
                                 "replacement (with --dataset-resampled)")
            weights = [float(w) for w in args.train_data_upsampling_factors.split("::")]
        reader = WebDatasetReader(
            args.train_data, transform=preprocess_train, resampled=args.dataset_resampled, weights=weights,
            json_caption_key="caption" if args.json_captions else None, shuffle=True, seed=args.seed,
            rank=info.rank, world_size=info.world_size, num_workers=args.workers)
        data["train"] = WdsLoader(reader, args.batch_size * args.accum_freq, tokenizer=tokenizer,
                                  num_samples=(args.train_num_samples or 0) // info.world_size)
    elif dataset_type in ("csv", "tsv"):
        train_ds = TsvDataset(args.train_data, img_transform=preprocess_train)
    elif dataset_type == "synthetic":
        train_ds = SyntheticDataset(preprocess_train, image_size=preprocess_train.size,
                                    dataset_size=args.train_num_samples or 100)
    if train_ds is not None:
        data["train"] = DataLoader(
            train_ds, args.batch_size * args.accum_freq, shuffle=True, seed=args.seed, drop_last=True,
            num_threads=args.workers, collate=_pinned(collate) if pin_memory else collate,
            rank=info.rank, world_size=info.world_size)
    if args.val_data:
        ds = TsvDataset(args.val_data, img_transform=preprocess_val)
        data["val"] = DataLoader(ds, args.batch_size, num_threads=args.workers, collate=collate)
    if args.imagenet_val:
        root = args.imagenet_val.rstrip("/")
        if root.endswith("val"):
            root = os.path.dirname(root)
        data["imagenet-val"] = DataLoader(ImageNet(root, split="val", transform=preprocess_val), args.batch_size,
                                          num_threads=args.workers)
    if args.imagenet_v2:
        data["imagenet-v2"] = DataLoader(ImageNetV2(args.imagenet_v2, transform=preprocess_val), args.batch_size,
                                         num_threads=args.workers)
    return data


def _to_device(batch, device: torch.device):
    return [torch.as_tensor(batch[k]).to(device, non_blocking=True) for k in ("images", "texts")]


def train_one_epoch(step_fn, loader, epoch: int, args, device: torch.device, info: DistInfo,
                    tb_writer, wandb_run) -> None:
    loader.set_epoch(epoch)
    num_batches_per_epoch = loader.num_batches
    # the log line's denominator: the dataset's rows, or the shards' epoch size over all ranks
    samples_per_epoch = loader.num_samples * info.world_size if isinstance(loader, WdsLoader) else len(loader.dataset)
    sample_digits = math.ceil(math.log10(samples_per_epoch + 1))
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
            num_samples = batch_count * args.batch_size * args.accum_freq * info.world_size
            percent_complete = 100.0 * batch_count / num_batches_per_epoch
            samples_per_second_per_gpu = args.accum_freq * args.batch_size / batch_time_m.avg
            samples_per_second = samples_per_second_per_gpu * info.world_size
            logging.info(
                f"Train Epoch: {epoch} [{num_samples:>{sample_digits}}/{samples_per_epoch} "
                f"({percent_complete:.0f}%)] "
                f"Loss: {losses_m.val:#.5g} ({losses_m.avg:#.4g}) "
                f"Data (t): {data_time_m.avg:.3f} "
                f"Batch (t): {batch_time_m.avg:.3f}, {samples_per_second:#g}/s, "
                f"{samples_per_second_per_gpu:#g}/s/gpu "
                f"Scale: {scale_val:.3f}"
            )
            log_data = [
                ("train/loss", losses_m.val),
                ("train/logit_scale", scale_val),
                ("train/samples_per_second", samples_per_second),
                ("train/samples_per_second_per_gpu", samples_per_second_per_gpu),
                ("train/data_time", data_time_m.avg),
                ("train/batch_time", batch_time_m.avg),
            ]
            if tb_writer is not None:
                for name, val in log_data:
                    tb_writer.add_scalar(name, val, step)
            if wandb_run is not None:
                wandb_run.log(dict(log_data), step=step)
            batch_time_m.reset()
            data_time_m.reset()
    for loss, _ in pending:  # a loader shorter than num_batches: keep every loss
        losses_m.update(float(loss), n=args.batch_size)


def _setup_logging(log_file: Optional[str]):
    """Console (and, given a path, file) handlers on the root logger;
    returns them for removal."""
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s", datefmt="%Y-%m-%d,%H:%M:%S")
    handlers = [logging.StreamHandler()] + ([logging.FileHandler(log_file)] if log_file else [])
    root = logging.getLogger()
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)
    root.setLevel(logging.INFO)
    return handlers


def _tensorboard_writer(log_dir: str):
    """A TensorBoard ``SummaryWriter`` at ``log_dir``; None, with JAX's
    warning, when tensorboard does not import."""
    try:
        from torch.utils.tensorboard.writer import SummaryWriter
    except ImportError:
        logging.warning("tensorboard unavailable; skipping --report-to tensorboard")
        return None
    return SummaryWriter(log_dir=log_dir)


def _append_results(checkpoint_path: str, metrics: Dict) -> None:
    if metrics:
        with open(os.path.join(checkpoint_path, "results.jsonl"), "a+") as fh:
            fh.write(json.dumps(metrics) + "\n")


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    owns_group = not dist.is_initialized()
    if owns_group:
        init_distributed_from_env(args.dist_url, device, args.dist_backend)
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return _main(args, device, dist.group.WORLD if dist.is_initialized() else None)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _main(args, device: torch.device, group) -> int:
    info = DistInfo.current()
    if args.name is None:
        date_str = datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
        args.name = "-".join([date_str, f"model_{args.model.replace('/', '-')}", f"lr_{args.lr}",
                              f"b_{args.batch_size}", f"j_{args.workers}", f"p_{args.precision}"])
        if group is not None:  # the ranks started at different seconds
            args.name = broadcast_object(args.name, group)
    resume_latest = args.resume == "latest"
    log_base_path = os.path.join(args.logs, args.name)
    log_path = os.path.join(log_base_path, "out.log")
    exists = False
    if info.is_master:
        os.makedirs(log_base_path, exist_ok=True)
        exists = os.path.exists(log_path) and not resume_latest
    if group is not None:
        exists = broadcast_object(exists, group)
    if exists:
        if info.is_master:
            print(f"Error. Experiment already exists. Use --name {args.name}-new to specify a new experiment.")
        return -1
    handlers = _setup_logging(log_path if info.is_master else None)
    tb_writer = wandb_run = None
    if info.is_master:  # the reference's is_master writes the reports
        if "tensorboard" in args.report_to or "all" in args.report_to:
            tb_writer = _tensorboard_writer(os.path.join(log_base_path, "tensorboard"))
        if "wandb" in args.report_to or "all" in args.report_to:
            wandb_run = init_wandb(args, log_base_path)
    try:
        return _train(args, device, group, info, log_base_path, resume_latest, tb_writer, wandb_run)
    finally:
        if tb_writer is not None:
            tb_writer.close()
        if wandb_run is not None:
            wandb_run.finish()
        for h in handlers:
            logging.getLogger().removeHandler(h)
            h.close()


def _train(args, device: torch.device, group, info: DistInfo, log_base_path: str, resume_latest: bool,
           tb_writer, wandb_run) -> int:
    checkpoint_path = os.path.join(log_base_path, "checkpoints")
    if info.is_master:
        os.makedirs(checkpoint_path, exist_ok=True)
    if resume_latest:
        args.resume = get_latest_checkpoint(checkpoint_path) if info.is_master else None
        if group is not None:
            args.resume = broadcast_object(args.resume, group)
        logging.info(f"Found latest resume checkpoint at {args.resume}." if args.resume
                     else f"No latest resume checkpoint found in {checkpoint_path}.")
    logging.info(f"Running on {device}"
                 + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                 + f"; {info.world_size} process(es), rank {info.rank}"
                 + (f", {dist.get_backend(group)}." if group is not None else "."))

    model = create_model(args.model, precision="fp32", device=device, seed=args.seed,
                         force_image_size=args.force_image_size,
                         force_patch_dropout=args.force_patch_dropout).train()
    preprocess_train = image_transform(model.cfg.image_size, is_train=True, seed=args.seed)
    preprocess_val = image_transform(model.cfg.image_size, is_train=False)
    tokenizer = get_tokenizer(args.model)
    data = get_data(args, preprocess_train, preprocess_val, tokenizer, pin_memory=device.type == "cuda", info=info)
    evals = [k for k in EVAL_SPLITS if k in data]
    if "train" not in data and not evals:
        raise ValueError("no data: pass --train-data (or --dataset-type synthetic), "
                         "--val-data, --imagenet-val or --imagenet-v2")

    optimizer = step_fn = None
    if "train" in data:
        loader = data["train"]
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
            seed=args.seed,
        )
        step_fn = make_train_step(model, optimizer, sched, step_cfg, group=group)

    start_epoch = 0
    if args.resume:
        extras = load_training_checkpoint(args.resume, model, optimizer)
        if isinstance(extras.get("epoch"), int):
            start_epoch = extras["epoch"]  # epoch_latest.pt carries no number in its name
        else:
            m = re.search(r"epoch_(\d+)", os.path.basename(args.resume))
            start_epoch = int(m.group(1)) if m else 0
        logging.info(f"=> resuming checkpoint '{args.resume}' (epoch {start_epoch})")
    if group is not None:
        broadcast_model(model, group)

    def run_evaluation(epoch: int, wandb_step: Optional[int] = None) -> None:
        if info.is_master:
            metrics = evaluate(model, data, epoch, args, tokenizer)
            _append_results(checkpoint_path, metrics)
            if wandb_run is not None:
                wandb_run.log({f"val/{k}": v for k, v in metrics.items() if isinstance(v, (int, float))},
                              step=wandb_step)
        if group is not None:
            dist.barrier(group)

    if "train" not in data:
        run_evaluation(start_epoch)
        return 0

    for epoch in range(start_epoch, args.epochs):
        logging.info(f"Start epoch {epoch}")
        train_one_epoch(step_fn, data["train"], epoch, args, device, info, tb_writer, wandb_run)
        completed_epoch = epoch + 1
        if evals:
            run_evaluation(completed_epoch, completed_epoch * data["train"].num_batches)
        if info.is_master and (completed_epoch == args.epochs or (
                args.save_frequency > 0 and completed_epoch % args.save_frequency == 0)):
            for name in [f"epoch_{completed_epoch}.pt"] + [LATEST_CHECKPOINT_NAME] * args.save_most_recent:
                save_checkpoint(os.path.join(checkpoint_path, name), model, optimizer,
                                epoch=completed_epoch, name=args.name)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
