"""Feature circuits per domain and class (paper Fig. 6).

Counterpart of ``scripts/compute_circuits.py``, with its flags plus
``--device``: IG node effects over the RN tower's 22 submodules (neuron
basis, or trained SAEs from ``--sae_dir``), the top ``--node_threshold``
fraction of nodes per submodule, and IG edge effects between adjacent
submodules; ``{label}_nodes.npz``, ``{label}_features_by_submod.npz`` and
``{label}_edges.npz`` per domain under ``<model_dir>/circuit_analysis``::

    python -m xclip_tpu_torch.scripts.compute_circuits --model RN50 \\
        --model_dir runs/rn50 --domainnet_path /data/domainnet --domain sketch --class_idx 0

The checkpoint is ``<model_dir>/checkpoints/epoch_32.pt``. The device
defaults to CUDA and must be present unless ``--device cpu`` is given; the
tower runs in fp32 without TF32, its 1x1 convs through K1/K2 on the card.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import ALL_DOMAINS, DomainNetCaptions
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX, domainnet_classes_from_samples
from xclip_tpu_torch.evals.zero_shot import OpenAIZeroShotClassifier
from xclip_tpu_torch.interp.circuit_model import VisualCircuitModel
from xclip_tpu_torch.interp.circuits import compute_class_circuit
from xclip_tpu_torch.interp.dictionary import IdentityDict, load_sae_dictionary, resolve_sae_checkpoint
from xclip_tpu_torch.models.factory import create_model
from xclip_tpu_torch.tokenizer import get_tokenizer


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Configure CLIP models for neuron analysis.")
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--domain", type=str, default="all", choices=ALL_DOMAINS + ["all"])
    parser.add_argument("--class_idx", type=int, default=None)
    parser.add_argument("--domainnet_path", type=str, required=True)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--samples_per_class", type=int, default=50)
    parser.add_argument("--regenerate", action="store_true")
    parser.add_argument("--node_threshold", type=float, default=0.1)
    parser.add_argument("--sae_dir", type=str, default=None,
                        help="directory of trained SAE checkpoints ({submodule}.pt/.npz or "
                        "{submodule}/checkpoints/sparse_autoencoder_final.pt); submodules without "
                        "one stay in the neuron basis (IdentityDict)")
    parser.add_argument("--edge_threshold", type=float, default=0.01)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    disable_tf32()
    random.seed(args.seed)
    np.random.seed(args.seed)
    device = resolve_device(args.device)

    ckpt = os.path.join(args.model_dir, "checkpoints/epoch_32.pt")
    assert os.path.isfile(ckpt), f"Checkpoint file not found: {ckpt}"
    model = create_model(args.model, pretrained=ckpt, device=device)
    preprocess_val = image_transform(model.cfg.image_size, is_train=False)
    tokenizer = get_tokenizer(args.model)

    domains = ALL_DOMAINS if args.domain == "all" else [args.domain]
    ref_data = DomainNetCaptions(args.domainnet_path, "val", transform=preprocess_val,
                                 exclude_domains=[d for d in ALL_DOMAINS if d != "real"])
    domainnet_classes = domainnet_classes_from_samples(ref_data.samples)

    clf = OpenAIZeroShotClassifier(model, tokenizer, domainnet_classes)
    circuit_model = VisualCircuitModel(model, clf.prompt_feat)

    # neuron basis (IdentityDict, the reference's default) unless --sae_dir
    # supplies trained SAEs for some submodules: those get feature-basis circuits
    dictionaries = None
    if args.sae_dir:
        dictionaries = {}
        for stage in circuit_model.stages:
            ckpt_path = resolve_sae_checkpoint(args.sae_dir, stage.name)
            dictionaries[stage.name] = (load_sae_dictionary(ckpt_path, device=device) if ckpt_path
                                        else IdentityDict(stage.channels))
        n_sae = sum(not isinstance(d, IdentityDict) for d in dictionaries.values())
        print(f"Using SAE dictionaries for {n_sae}/{len(dictionaries)} submodules from {args.sae_dir}")

    for domain in domains:
        data = DomainNetCaptions(args.domainnet_path, "val", transform=preprocess_val,
                                 exclude_domains=[d for d in ALL_DOMAINS if d != domain])
        out_folder = os.path.join(args.model_dir, "circuit_analysis", domain)
        os.makedirs(out_folder, exist_ok=True)

        label_to_indices = defaultdict(list)
        for idx, (_, label, _) in enumerate(data.samples):
            label_to_indices[label].append(idx)

        ood_labels = list(LSO_CLASS_TO_IDX.values())
        id_labels = [l for l in label_to_indices if l not in ood_labels]
        all_labels = [args.class_idx] if args.class_idx is not None else ood_labels + id_labels

        for label in all_labels:
            if os.path.exists(os.path.join(out_folder, f"{label}_edges.npz")) and not args.regenerate:
                continue
            indices = list(label_to_indices[label])
            random.shuffle(indices)
            images = np.stack([data[i][0] for i in indices[: args.samples_per_class]])
            compute_class_circuit(circuit_model, images, label, node_threshold=args.node_threshold,
                                  out_folder=out_folder, dictionaries=dictionaries)
    print("Done.")
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
