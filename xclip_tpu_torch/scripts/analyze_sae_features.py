"""SAE feature sharing across domains, paper Fig. 4.

Counterpart of ``scripts/analyze_sae_features.py``, with its flags plus
``--device``: the normalized image features of DomainNet-val (fp32, on the
device), the top-20 SAE features of each image, per class and domain
histograms (``{class}_{domain}_hist.npy``) and ``feature-sharing.json``
under ``--out_path``::

    python -m xclip_tpu_torch.scripts.analyze_sae_features --ckpt_path epoch_32.pt \\
        --sae_path runs/sae --domainnet_path /data/domainnet --out_path fs/ --domain sketch

The SAE is ``<sae_path>/checkpoints/sparse_autoencoder_final.pt``. The
device defaults to CUDA and must be present unless ``--device cpu`` is
given; fp32 without TF32.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import DomainNetCaptions
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.evals.features import extract_image_features
from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX, domain_ids_from_samples
from xclip_tpu_torch.interp.feature_sharing import evaluate_feature_sharing
from xclip_tpu_torch.models.factory import create_model
from xclip_tpu_torch.sae.model import sae_state_dict_to_params


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="RN50")
    parser.add_argument("--ckpt_path", type=str, required=True)
    parser.add_argument("--sae_path", type=str, required=True)
    parser.add_argument("--domainnet_path", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--domain", type=str, required=True)
    parser.add_argument("--input_dim", type=int, default=1024)
    parser.add_argument("--expansion_factor", type=int, default=4)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    disable_tf32()
    device = resolve_device(args.device)

    sd_path = os.path.join(args.sae_path, "checkpoints", "sparse_autoencoder_final.pt")
    sae_params = sae_state_dict_to_params(torch.load(sd_path, map_location="cpu", weights_only=False),
                                          device=device)
    n_learned = int(args.input_dim * args.expansion_factor)

    model = create_model(args.model, pretrained=args.ckpt_path, device=device)
    preprocess_val = image_transform(model.cfg.image_size, is_train=False)
    dataset = DomainNetCaptions(args.domainnet_path, "val", transform=preprocess_val)
    data = extract_image_features(model, dataset, num_workers=args.num_workers)
    domain_ids = domain_ids_from_samples(dataset.samples)

    os.makedirs(args.out_path, exist_ok=True)
    results = evaluate_feature_sharing(sae_params, data["img_feat"], np.asarray(data["clss"]), domain_ids,
                                       LSO_CLASS_TO_IDX, domain=args.domain, out_path=args.out_path,
                                       n_learned_features=n_learned)
    print("score:", results["score"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
