"""Training CLI flags: the subset of ``xclip_tpu/train/params.py`` that the
port's training path uses, with the same names and defaults (reference
training/params.py), so reference launch commands for this path work.

The loss always takes the local row block with the differentiable gather,
as the JAX trainer does (train/main.py:505-510), so ``--local-loss`` and
``--gather-with-grad`` select what is already on; they are accepted for the
reference's commands. ``--dist-url`` and ``--dist-backend`` reach
``parallel.distributed.init_distributed_from_env`` (no backend: NCCL on
the card, gloo on the CPU). ``--device`` picks the device: ``cuda`` (the
default, raising without a card) or ``cpu``. ``--report-to`` takes
``tensorboard``, ``wandb`` or ``all`` (substrings, as JAX reads it):
rank 0 writes the train scalars to ``<logs>/<name>/tensorboard`` and, for
wandb, the train and val metrics to wandb or, without the package, to
``<logs>/<name>/wandb-offline``. Tar shards (``--dataset-type webdataset``,
or ``auto`` on a ``.tar`` name) take ``--dataset-resampled``,
``--json-captions`` and ``--train-data-upsampling-factors`` with JAX's
defaults, and need ``--train-num-samples``.
"""

from __future__ import annotations

import argparse


def parse_args(args=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser("xclip_tpu_torch CLIP training")
    # data
    parser.add_argument("--train-data", type=str, default=None,
                        help="TSV/CSV with a 'filepath\\ttitle' header, or tar shards ('shards-{000..009}.tar', "
                             "'::' between sources)")
    parser.add_argument("--val-data", type=str, default=None,
                        help="TSV/CSV of (image, caption) pairs for the val loss and retrieval metrics")
    parser.add_argument("--dataset-type", choices=["csv", "tsv", "webdataset", "synthetic", "auto"], default="auto")
    parser.add_argument("--dataset-resampled", default=False, action="store_true",
                        help="webdataset: draw shards with replacement")
    parser.add_argument("--json-captions", default=False, action="store_true",
                        help="load webdataset captions from json files (key 'caption') instead of txt")
    parser.add_argument("--train-data-upsampling-factors", type=str, default=None,
                        help="'::'-separated per-source sampling weights for resampled webdataset "
                             "(e.g. 1::2::0.5); requires --dataset-resampled")
    parser.add_argument("--imagenet-val", type=str, default=None,
                        help="ImageNet root (or its val/ folder) for the zero-shot eval")
    parser.add_argument("--imagenet-v2", type=str, default=None,
                        help="path to an extracted ImageNet-V2 tree for zero-shot eval")
    parser.add_argument("--train-num-samples", type=int, default=None)
    parser.add_argument("--workers", type=int, default=8, help="decode threads of the loader")
    # model
    parser.add_argument("--model", type=str, default="RN50", help="an RN or plain ViT config (RN50, ViT-B-16, ...)")
    parser.add_argument("--force-image-size", type=int, default=None)
    parser.add_argument("--force-patch-dropout", type=float, default=None,
                        help="override the ViT config's patch dropout (e.g. 0.5 for FLIP-style training)")
    parser.add_argument("--precision", type=str, default="amp",
                        choices=["amp", "amp_bf16", "amp_bfloat16", "bf16", "fp16", "pure_bf16", "fp32"])
    # optimization
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=32)
    parser.add_argument("--epochs-cooldown", type=int, default=None)
    parser.add_argument("--lr", type=float, default=5.0e-4)
    parser.add_argument("--beta1", type=float, default=0.9)
    parser.add_argument("--beta2", type=float, default=0.98)
    parser.add_argument("--eps", type=float, default=1.0e-6)
    parser.add_argument("--wd", type=float, default=0.2)
    parser.add_argument("--warmup", type=int, default=10000)
    parser.add_argument("--lr-scheduler", type=str, default="cosine",
                        choices=["cosine", "const", "const-cooldown"])
    parser.add_argument("--lr-cooldown-end", type=float, default=0.0)
    parser.add_argument("--lr-cooldown-power", type=float, default=1.0)
    parser.add_argument("--accum-freq", type=int, default=1)
    parser.add_argument("--grad-clip-norm", type=float, default=None)
    parser.add_argument("--grad-checkpointing", action="store_true")
    # loss: the step always uses the local row block and the differentiable
    # gather (the JAX trainer's layout); the flags keep reference commands working
    parser.add_argument("--local-loss", action="store_true")
    parser.add_argument("--gather-with-grad", action="store_true")
    # evaluation
    parser.add_argument("--zeroshot-frequency", type=int, default=2)
    parser.add_argument("--val-frequency", type=int, default=1)
    # logging / checkpointing
    parser.add_argument("--logs", type=str, default="./logs/")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None, help="a checkpoint path, or 'latest'")
    parser.add_argument("--save-frequency", type=int, default=1)
    parser.add_argument("--save-most-recent", action="store_true")
    parser.add_argument("--report-to", type=str, default="",
                        help="'tensorboard', 'wandb' or 'all' (e.g. 'tensorboard,wandb')")
    parser.add_argument("--wandb-notes", type=str, default="", help="notes for the wandb run")
    parser.add_argument("--wandb-project-name", type=str, default="open-clip", help="wandb project")
    parser.add_argument("--log-every-n-steps", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    # several processes (torchrun, SLURM, MPI)
    parser.add_argument("--dist-url", type=str, default=None,
                        help="rendezvous of rank 0 ('env://' or 'tcp://host:port'); by default read "
                             "from the launcher's environment (MASTER_ADDR/MASTER_PORT, SLURM)")
    parser.add_argument("--dist-backend", type=str, default=None,
                        help="torch.distributed backend; default nccl on cuda, gloo on cpu")
    return parser.parse_args(args)
