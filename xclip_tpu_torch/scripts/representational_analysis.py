"""CKA representational similarity across domains, paper Fig. 6a.

Counterpart of ``scripts/representational_analysis.py``, with its flags
plus ``--device``: every stage activation of the RN tower (spatial means
of the feature maps, fp32, on the device), class means per domain, and
linear or RBF CKA with the unbiased HSIC1 estimator (float64) over each
pair of domains and the all / ood / id class subsets with at least five
classes, into ``<out_path>/cka_{kernel}.json``::

    python -m xclip_tpu_torch.scripts.representational_analysis --model_dir runs/rn50 \\
        --domainnet_path /data/domainnet --out_path cka/ --kernel linear

The checkpoint is ``<model_dir>/checkpoints/epoch_32.pt``. The device
defaults to CUDA and must be present unless ``--device cpu`` is given;
products and convolutions run in full fp32 (no TF32).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import ALL_DOMAINS, DomainNetCaptions
from xclip_tpu_torch.data.loader import DataLoader
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX
from xclip_tpu_torch.interp.cka import class_mean_activations, hsic1, kernel_cka, linear_cka
from xclip_tpu_torch.models.factory import create_model
from xclip_tpu_torch.models.resnet import resnet_stage_names


@torch.inference_mode()
def capture_pooled_activations(model, dataset, batch_size: int, num_threads: int):
    """All stage activations, spatial means of the feature maps (reference
    hooks + pooling :126-131, 237-259) -> ({stage: (N, C)}, labels)."""
    names = resnet_stage_names(model.cfg.vision)
    device = next(model.parameters()).device
    acc = {k: [] for k in names}
    labels = []
    for images, lab in DataLoader(dataset, batch_size, num_threads=num_threads):
        _, inters = model.visual.run_stages(torch.from_numpy(images).to(device), capture=names)
        for k in names:
            v = inters[k]
            acc[k].append((v.mean(dim=(2, 3)) if v.dim() == 4 else v).float().cpu().numpy())
        labels.append(lab)
    return {k: np.concatenate(v) for k, v in acc.items()}, np.concatenate(labels)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="RN50")
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--domainnet_path", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--kernel", type=str, default="linear", choices=["linear", "rbf"])
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    disable_tf32()

    ckpt = os.path.join(args.model_dir, "checkpoints/epoch_32.pt")
    assert os.path.isfile(ckpt), ckpt
    model = create_model(args.model, pretrained=ckpt, device=resolve_device(args.device))
    preprocess_val = image_transform(model.cfg.image_size, is_train=False)

    per_domain = {}
    for domain in ALL_DOMAINS:
        ds = DomainNetCaptions(args.domainnet_path, "val", transform=preprocess_val,
                               exclude_domains=[d for d in ALL_DOMAINS if d != domain])
        per_domain[domain] = capture_pooled_activations(model, ds, args.batch_size, args.num_workers)

    ood = np.array(sorted(LSO_CLASS_TO_IDX.values()))
    cka_fn = {"linear": linear_cka, "rbf": kernel_cka}[args.kernel]
    results = {"all": {}, "ood": {}, "id": {}}
    for layer in resnet_stage_names(model.cfg.vision):
        for split in results:
            results[split][layer] = {}
        for da, db in itertools.combinations(ALL_DOMAINS, r=2):
            acts_a, labels_a = per_domain[da]
            acts_b, labels_b = per_domain[db]
            shared = np.intersect1d(np.unique(labels_a), np.unique(labels_b))
            splits = {"all": shared, "ood": shared[np.isin(shared, ood)], "id": shared[~np.isin(shared, ood)]}
            for split, classes in splits.items():
                if len(classes) < 5:
                    continue
                in_a, in_b = np.isin(labels_a, classes), np.isin(labels_b, classes)
                ma = class_mean_activations(acts_a[layer][in_a], labels_a[in_a])
                mb = class_mean_activations(acts_b[layer][in_b], labels_b[in_b])
                results[split][layer][f"{da}|{db}"] = cka_fn(ma, mb, hsic1)

    os.makedirs(args.out_path, exist_ok=True)
    with open(os.path.join(args.out_path, f"cka_{args.kernel}.json"), "w") as fh:
        json.dump(results, fh)
    for split in results:
        vals = [v for layer in results[split].values() for v in layer.values()]
        if vals:
            print(f"{split}: mean CKA {np.mean(vals):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
