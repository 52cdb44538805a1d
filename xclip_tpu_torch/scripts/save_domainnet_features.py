"""Cache the normalized DomainNet-val image features of a checkpoint series.

Counterpart of ``scripts/save_domainnet_features.py``: for each checkpoint,
encode DomainNet-val (fp32, L2-normalized) and write ``img_feat.npy``
(checkpoints x N x D), ``domain_labels.npy`` (class labels) and
``domain_ids.npy`` (index of each image's domain) under ``--out_path``.

    python -m xclip_tpu_torch.scripts.save_domainnet_features --model RN50 \\
        --ckpt_files epoch_1.pt epoch_32.pt --domainnet_path /data/domainnet --out_path feats/

``--device`` is ``cuda`` by default (raising without a card) or ``cpu``.
Products and convolutions run in full fp32 (no TF32).
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence

import numpy as np

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import DomainNetCaptions
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.evals.features import extract_image_features
from xclip_tpu_torch.evals.lso import domain_ids_from_samples
from xclip_tpu_torch.models.factory import create_model, get_clip_cfg


def save_features(model_name: str, ckpt_files: Sequence[str], out_path: str, domainnet_path: str,
                  *, num_workers: int = 8, device: str = "cuda") -> None:
    dev = resolve_device(device)
    preprocess_val = image_transform(get_clip_cfg(model_name).image_size, is_train=False)
    dataset = DomainNetCaptions(domainnet_path, "val", transform=preprocess_val)
    ids = domain_ids_from_samples(dataset.samples)
    if np.unique(ids).size != 6:
        raise ValueError(f"DomainNet-val must hold all six domains, found {np.unique(ids).size}")

    img_feats, domain_labels = [], None
    for ckpt_file in ckpt_files:
        model = create_model(model_name, pretrained=ckpt_file, device=dev)
        data = extract_image_features(model, dataset, batch_size=256, num_workers=num_workers)
        img_feats.append(data["img_feat"])
        if domain_labels is None:
            domain_labels = data["clss"]
        elif not np.array_equal(domain_labels, data["clss"]):
            raise RuntimeError(f"{ckpt_file}: labels differ from the first checkpoint's")
        del model

    os.makedirs(out_path, exist_ok=True)
    np.save(os.path.join(out_path, "img_feat.npy"), np.stack(img_feats))
    np.save(os.path.join(out_path, "domain_labels.npy"), domain_labels)
    np.save(os.path.join(out_path, "domain_ids.npy"), ids)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Cache DomainNet-val image features of CLIP checkpoints.")
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--ckpt_files", type=str, nargs="+", required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--domainnet_path", type=str, required=True)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    disable_tf32()
    save_features(args.model, args.ckpt_files, args.out_path, args.domainnet_path,
                  num_workers=args.num_workers, device=args.device)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
