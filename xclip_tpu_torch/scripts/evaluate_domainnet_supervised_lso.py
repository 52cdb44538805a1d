"""DomainNet-LSO evaluation of the supervised 1345-way classifier.

Counterpart of ``scripts/evaluate_domainnet_supervised_lso.py``, with its
flags, plus ``--device``::

    python -m xclip_tpu_torch.scripts.evaluate_domainnet_supervised_lso --model rn50-clip \\
        --domain sketch --ckpt_files ckpts/epoch=*.npz --domainnet_path domainnet/ \\
        --out_path ckpts/lso-eval-sketch

The checkpoints (native ``.npz`` files of either package) are sorted by the
number after ``epoch`` (``epoch=N`` or ``epochN``; 0 without one), which
is also their step in ``results.json``. The classifier is built once on the
device and each checkpoint's weights are loaded into it; its fp32 logits
over the target domain's and ``real``'s DomainNet val images are cut to the
DomainNet range ``1000:1345`` before the argmax. The metrics are the LSO
protocol's for DomainNet alone (``imagenet-val`` stays empty), written as
``<out_path>/results.json`` in the JAX layout. The device defaults to CUDA
and must be present unless ``--device cpu`` is given; fp32 runs without
TF32.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
from typing import Optional, Sequence

from xclip_tpu_torch.core.precision import disable_tf32
from xclip_tpu_torch.data.datasets import DomainNetCaptions
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.evals.lso import (
    domain_ids_from_samples,
    domainnet_classes_from_samples,
    evaluate_lso,
    merge_step_results,
)
from xclip_tpu_torch.evals.run_lso import EVAL_DOMAINS
from xclip_tpu_torch.train.learner import (
    ClassifierCfg,
    classifier_predictions,
    create_classifier,
    load_classifier,
)

DOMAINNET_LOGITS = (1000, 1345)


def epoch_from_file(path: str) -> int:
    m = re.search(r"epoch=?(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Supervised DomainNet-LSO evaluation (PyTorch/CUDA port).")
    parser.add_argument("--model", type=str, default="rn50-clip")
    parser.add_argument("--domain", type=str, required=True, choices=EVAL_DOMAINS)
    parser.add_argument("--ckpt_files", type=str, nargs="+", required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--domainnet_path", type=str, required=True)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    disable_tf32()

    model = create_classifier(ClassifierCfg(model=args.model, num_classes=1345), device=args.device)
    exclude = [d for d in EVAL_DOMAINS if d != args.domain]
    dataset = DomainNetCaptions(args.domainnet_path, "val", transform=image_transform(model.image_size),
                                exclude_domains=exclude)
    domainnet_classes = domainnet_classes_from_samples(dataset.samples)
    domain_ids = domain_ids_from_samples(dataset.samples)

    ckpts = sorted(args.ckpt_files, key=epoch_from_file)
    steps = [epoch_from_file(f) for f in ckpts]
    results_per_step = []
    for ckpt in ckpts:
        logging.info("Evaluating %s", ckpt)
        load_classifier(ckpt, model)
        data = classifier_predictions(model, dataset, num_threads=args.num_workers, logit_slice=DOMAINNET_LOGITS)
        results_per_step.append(evaluate_lso(
            domain_labels=data["labels"], domain_pred=data["pred"], domain_ids=domain_ids,
            domain=args.domain, domainnet_classes=domainnet_classes))

    os.makedirs(args.out_path, exist_ok=True)
    results = merge_step_results(results_per_step, steps, args.domain)
    with open(os.path.join(args.out_path, "results.json"), "w") as fh:
        json.dump(results, fh)
    print(json.dumps(results["domainnet-val"]["accuracy"], indent=1)[:500])
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
