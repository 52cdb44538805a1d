"""Cache CLIP image features, then train a sparse autoencoder on them.

Counterpart of ``scripts/train_sae.py``: encode DomainNet (and, without
``--domainnet_only``, CC12M) with a CLIP checkpoint into fp16 shards under
``<out_dir>/activations`` (kept between runs), then train the SAE with the
L1 + L2 loss, Adam with per-neuron moment reset and dead-neuron resampling,
writing ``<out_dir>/checkpoints/sparse_autoencoder_*.pt``.

    python -m xclip_tpu_torch.scripts.train_sae --out_dir out --ckpt_path epoch_32.pt \\
        --domainnet_path /data/domainnet --domainnet_only

Flags and defaults are the JAX script's (1024 -> 4096 features, batch 4096,
one hook point ``out``, so the SAE has a components axis of 1), plus
``--device`` (``cuda`` by default, raising without a card; ``cpu``).
Scalars go to TensorBoard when ``torch.utils.tensorboard`` imports; the JAX
script's wandb logging is not ported. Products and convolutions run in
full fp32 (no TF32).
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import time
from typing import Optional, Sequence

import torch

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import DomainNetCaptions, TsvDataset
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.models.factory import create_model
from xclip_tpu_torch.sae import optim as sae_optim
from xclip_tpu_torch.sae.cache import cache_image_features, concat_datasets
from xclip_tpu_torch.sae.losses import SAELossCfg
from xclip_tpu_torch.sae.model import SAECfg, sae_init
from xclip_tpu_torch.sae.pipeline import Pipeline
from xclip_tpu_torch.sae.resampler import ActivationResampler


def save_activations(args, device: torch.device) -> None:
    """Write the train and validation feature shards that are missing."""
    acts_dir = os.path.join(args.out_dir, "activations")
    os.makedirs(acts_dir, exist_ok=True)
    model = create_model(args.img_enc_name, pretrained=args.ckpt_path, device=device)
    preprocess_val = image_transform(model.cfg.image_size, is_train=False)

    def has(prefix):
        return any(f.startswith(prefix) for f in os.listdir(acts_dir))

    def dataset(split: str):
        dn = DomainNetCaptions(args.domainnet_path, split, transform=preprocess_val, mode="none")
        if args.domainnet_only:
            return dn
        tsv = os.path.join(args.cc12m_path, f"cc12m-{split}.tsv")
        return concat_datasets([dn, TsvDataset(tsv, img_transform=preprocess_val, return_caption=False)])

    def cache(split: str, prefix: str, shard_batches: Optional[int]) -> None:
        ds = dataset(split)
        t0 = time.perf_counter()
        paths = cache_image_features(model, ds, acts_dir, prefix=prefix, shard_batches=shard_batches,
                                     batch_size=args.activations_bs, num_threads=args.num_workers)
        logging.info("cached the features of %d images in %d shard(s) in %.3f s", len(ds), len(paths),
                     time.perf_counter() - t0)

    if not has("train_activations"):
        cache("train", "train_activations", None if args.domainnet_only else 295)  # the reference's CC12M shards
    if not has("train_val_activations"):
        cache("val", "train_val_activations", None)


def tensorboard_writer(log_dir: str):
    """A TensorBoard ``SummaryWriter``, or None when it does not import."""
    try:
        from torch.utils.tensorboard.writer import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir=log_dir)


def train_sae(args, device: torch.device) -> Pipeline:
    ckpt_dir = os.path.join(args.out_dir, "checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir, exist_ok=False)

    n_learned = int(args.input_dim * args.expansion_factor)
    cfg = SAECfg(args.input_dim, n_learned, n_components=len(args.hook_points))
    params = sae_init(torch.Generator().manual_seed(args.seed), cfg, device=device)
    resampler = ActivationResampler(
        n_learned_features=n_learned,
        resample_interval=1,
        n_activations_activity_collate=1,
        max_n_resamples=10**9,
        resample_epoch_freq=args.resample_freq,
        resample_dataset_size=args.resample_dataset_size,
        seed=args.seed,
    )
    pipe = Pipeline(
        params,
        SAELossCfg(l1_coefficient=args.l1_coeff),
        sae_optim.adam(args.lr, b1=args.adam_beta_1, b2=args.adam_beta_2, eps=args.adam_epsilon),
        ckpt_dir,
        activation_resampler=resampler,
        logger=tensorboard_writer(os.path.join(args.out_dir, "tensorboard")),
        seed=args.seed,
    )

    acts_dir = os.path.join(args.out_dir, "activations")
    fnames = os.listdir(acts_dir)
    train_fnames = [os.path.join(acts_dir, f) for f in fnames
                    if f.startswith("train") and not f.startswith("train_val")]
    train_val_fnames = [os.path.join(acts_dir, f) for f in fnames if f.startswith("train_val")]
    if args.val_freq == 0:
        train_fnames, train_val_fnames = train_fnames + train_val_fnames, None

    t0 = time.perf_counter()
    try:
        pipe.run_pipeline(
            train_batch_size=args.train_sae_bs,
            checkpoint_frequency=args.ckpt_freq,
            val_frequency=args.val_freq,
            num_epochs=args.num_epochs,
            train_fnames=train_fnames,
            train_val_fnames=train_val_fnames,
        )
    finally:
        if pipe.logger is not None:
            pipe.logger.close()
    logging.info("trained the SAE on %d activations in %.3f s", pipe.total_activations_trained_on,
                 time.perf_counter() - t0)
    return pipe


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Cache CLIP features and train an SAE (PyTorch/CUDA port).")
    parser.add_argument("--l1_coeff", type=float, default=3e-4)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--adam_beta_1", type=float, default=0.9)
    parser.add_argument("--adam_beta_2", type=float, default=0.999)
    parser.add_argument("--adam_epsilon", type=float, default=1e-8)
    parser.add_argument("--adam_weight_decay", type=float, default=0.0, help="accepted and unused, as in the JAX script")
    parser.add_argument("--img_enc_name", type=str, default="RN50")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--domainnet_path", type=str, required=True)
    parser.add_argument("--cc12m_path", type=str, default="")
    parser.add_argument("--domainnet_only", action="store_true", default=False)
    parser.add_argument("--activations_bs", type=int, default=1024)
    parser.add_argument("--num_workers", type=int, default=6, help="decode threads of the feature cache")
    parser.add_argument("--hook_points", nargs="*", default=["out"])
    parser.add_argument("--resample_freq", type=int, default=500_000)
    parser.add_argument("--resample_dataset_size", type=int, default=819_200)
    parser.add_argument("--val_freq", type=int, default=50_000)
    parser.add_argument("--ckpt_freq", type=int, default=500_000)
    parser.add_argument("--input_dim", type=int, default=1024)
    parser.add_argument("--train_sae_bs", type=int, default=4096)
    parser.add_argument("--expansion_factor", type=int, default=4)
    parser.add_argument("--num_epochs", type=int, default=200)
    parser.add_argument("--seed", type=int, default=49)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    save_activations(args, device)
    train_sae(args, device)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
