"""Zero-shot DomainNet-LSO evaluation of a checkpoint series.

Counterpart of ``xclip_tpu/evals/run_lso.py`` (``evaluate_checkpoint`` and
``run_lso_evaluation``, :54-194) behind the flags of
``scripts/evaluate_domainnet_lso_openai.py``, plus ``--device`` and the
top-k evaluator's ``--topk`` (``scripts/evaluate_domainnet_lso_openai_topk.py``,
whose port is ``xclip_tpu_torch.scripts.evaluate_domainnet_lso_openai_topk``):

    python -m xclip_tpu_torch.evals.run_lso --model RN50 --domain sketch \\
        --ckpt_files epoch_1.pt epoch_2.pt --out_path out/ \\
        --imagenet_path imagenet/ --domainnet_path domainnet/ --precision bf16

writes the same ``results.json`` and prediction ``.npy`` files as the JAX
evaluator; with ``--topk 1 5 10`` each step also gets ``top-{k}-accuracy``
and a macro ``f1-score`` for ``imagenet-val`` and for each of {domain,
real} x {lso-ood, lso-id} (the macro F1 in numpy, ``lso.f1_macro``). The
device defaults to CUDA and must be present unless ``--device cpu`` is
given. fp32 products and convolutions run in full fp32 (no TF32).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.core.precision import disable_tf32, get_policy
from xclip_tpu_torch.data.datasets import DOMAIN_TO_IDX, DomainNetCaptions, ImageNet
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.evals.features import extract_image_features
from xclip_tpu_torch.evals.lso import (
    LSO_CLASS_TO_IDX,
    domain_ids_from_samples,
    domainnet_classes_from_samples,
    epoch_or_step_from_ckpt_file,
    evaluate_lso,
    f1_macro,
    merge_step_results,
    serialize_predictions,
    top_k_accuracy,
)
from xclip_tpu_torch.evals.metadata import XCLIP_IMAGENET_CLASSES
from xclip_tpu_torch.evals.zero_shot import OpenAIZeroShotClassifier
from xclip_tpu_torch.models.factory import create_model, get_clip_cfg
from xclip_tpu_torch.tokenizer import get_tokenizer

EVAL_DOMAINS = ["clipart", "infograph", "painting", "quickdraw", "sketch"]


def load_eval_data(model_name: str, imagenet_path: str, domainnet_path: str, domain: str) -> Dict:
    """ImageNet val + DomainNet val (target domain + real)."""
    preprocess_val = image_transform(get_clip_cfg(model_name).image_size, is_train=False)
    exclude = [d for d in EVAL_DOMAINS if domain and d != domain]
    return {
        "val": ImageNet(imagenet_path, split="val", transform=preprocess_val),
        "domain": DomainNetCaptions(domainnet_path, "val", transform=preprocess_val,
                                    exclude_domains=exclude),
    }


def evaluate_checkpoint(
    model,
    tokenizer,
    data: Dict,
    domain: str,
    domainnet_classes: Dict[int, str],
    domain_invariant: bool = False,
    batch_size: int = 250,
    num_workers: int = 8,
    precision: str = "fp32",
    topk: Optional[List[int]] = None,
):
    """One checkpoint: image features, both zero-shot heads, LSO metrics.
    ``precision`` as in the JAX evaluator: ``bf16`` computes in bfloat16;
    ``fp16`` computes in IEEE half and scores with half features and
    classifier weights, as the reference's ``.half()`` eval encoders do.
    ``topk`` adds the top-k accuracies and macro F1 scores."""
    if precision in ("fp16", "float16"):
        precision = "float16"
    dtype = get_policy(precision).compute_dtype if precision != "fp32" else None
    half = np.float16 if precision == "float16" else None

    def maybe_half(feat):
        return feat.astype(half) if half is not None else feat

    t0 = time.perf_counter()
    val_data = extract_image_features(model, data["val"], batch_size=batch_size,
                                      num_workers=num_workers, dtype=dtype)
    t1 = time.perf_counter()
    logging.info("ImageNet-val features: %d images in %.2f s", len(val_data["clss"]), t1 - t0)
    zs = OpenAIZeroShotClassifier(model, tokenizer, XCLIP_IMAGENET_CLASSES, domain_invariant, dtype=dtype)
    zs.prompt_feat = maybe_half(zs.prompt_feat)
    val_scores = zs.predict_from_features(maybe_half(val_data["img_feat"]), return_scores=True)["pred"]
    val_pred = val_scores.argmax(axis=1)
    val_labels = np.asarray(val_data["clss"])

    t2 = time.perf_counter()
    domain_data = extract_image_features(model, data["domain"], batch_size=batch_size,
                                         num_workers=num_workers, dtype=dtype)
    t3 = time.perf_counter()
    logging.info("DomainNet-val features: %d images in %.2f s", len(domain_data["clss"]), t3 - t2)
    domain_ids = domain_ids_from_samples(data["domain"].samples)
    if np.unique(domain_ids).size != 2:
        raise ValueError("the DomainNet split must hold exactly 'real' and the target domain")

    zs_dn = OpenAIZeroShotClassifier(model, tokenizer, domainnet_classes, domain_invariant, dtype=dtype)
    zs_dn.prompt_feat = maybe_half(zs_dn.prompt_feat)
    dn_scores = zs_dn.predict_from_features(maybe_half(domain_data["img_feat"]), return_scores=True)["pred"]
    domain_pred = dn_scores.argmax(axis=1)
    domain_labels = np.asarray(domain_data["clss"])
    logging.info("checkpoint evaluated in %.2f s", time.perf_counter() - t0)

    res = evaluate_lso(
        val_labels=val_labels, val_pred=val_pred,
        domain_labels=domain_labels, domain_pred=domain_pred, domain_ids=domain_ids,
        domain=domain, domainnet_classes=domainnet_classes,
    )
    if topk:
        add_topk_metrics(res, topk, val_scores, val_labels, val_pred, dn_scores, domain_labels, domain_pred,
                         domain_ids, domain)
    return res, (val_labels, val_pred, domain_labels, domain_pred, domain_ids)


def add_topk_metrics(res: Dict, topk: List[int], val_scores, val_labels, val_pred, dn_scores, domain_labels,
                     domain_pred, domain_ids, domain: str) -> None:
    """The top-k evaluator's keys, in place (JAX run_lso.py:114-150):
    ``top-{k}-accuracy`` and ``f1-score`` (macro) for ``imagenet-val``
    (``total``) and for each of {domain, real} x {lso-ood, lso-id}."""
    for k in topk:
        res["imagenet-val"][f"top-{k}-accuracy"] = {"total": top_k_accuracy(val_scores, val_labels, k)}
        res["domainnet-val"].setdefault(f"top-{k}-accuracy", {})
    res["imagenet-val"]["f1-score"] = {"total": f1_macro(val_labels, val_pred)}
    res["domainnet-val"]["f1-score"] = {}
    lso_vals = list(LSO_CLASS_TO_IDX.values())
    for dom in [domain, "real"]:
        mask = domain_ids == DOMAIN_TO_IDX[dom]
        kw_labels, kw_scores, kw_pred = domain_labels[mask], dn_scores[mask], domain_pred[mask]
        lso_mask = np.isin(kw_labels, lso_vals)
        for k in topk:
            acc = res["domainnet-val"][f"top-{k}-accuracy"]
            acc[f"{dom}-lso-ood"] = top_k_accuracy(kw_scores[lso_mask], kw_labels[lso_mask], k)
            acc[f"{dom}-lso-id"] = top_k_accuracy(kw_scores[~lso_mask], kw_labels[~lso_mask], k)
        res["domainnet-val"]["f1-score"][f"{dom}-lso-ood"] = f1_macro(kw_labels[lso_mask], kw_pred[lso_mask])
        res["domainnet-val"]["f1-score"][f"{dom}-lso-id"] = f1_macro(kw_labels[~lso_mask], kw_pred[~lso_mask])


def run_lso_evaluation(
    model_name: str,
    ckpt_files: List[str],
    out_path: str,
    imagenet_path: str,
    domainnet_path: str,
    domain: str,
    domain_invariant: bool = False,
    num_workers: int = 8,
    topk: Optional[List[int]] = None,
    precision: str = "fp32",
    device: Union[str, torch.device] = "cuda",
) -> Dict:
    """Full checkpoint-series protocol -> results.json + prediction .npy."""
    dev = resolve_device(device)
    ckpt_files = sorted(ckpt_files, key=epoch_or_step_from_ckpt_file)
    steps = [epoch_or_step_from_ckpt_file(f) for f in ckpt_files]

    data = load_eval_data(model_name, imagenet_path, domainnet_path, domain)
    domainnet_classes = domainnet_classes_from_samples(data["domain"].samples)
    for cls, label in LSO_CLASS_TO_IDX.items():
        if domainnet_classes.get(label) != cls:
            raise ValueError(f"DomainNet label {label} must be {cls!r}, found {domainnet_classes.get(label)!r}")

    tokenizer = get_tokenizer(model_name)
    results_per_step, predictions = [], []
    for step, ckpt in zip(steps, ckpt_files):
        logging.info("Evaluating %s (step %d)", ckpt, step)
        t0 = time.perf_counter()
        model = create_model(model_name, pretrained=ckpt, device=dev)
        logging.info("model loaded in %.2f s", time.perf_counter() - t0)
        res, preds = evaluate_checkpoint(
            model, tokenizer, data, domain, domainnet_classes,
            domain_invariant=domain_invariant, num_workers=num_workers, precision=precision, topk=topk,
        )
        results_per_step.append(res)
        predictions.append(preds)

    os.makedirs(out_path, exist_ok=True)
    serialize_predictions(predictions, out_path)
    results = merge_step_results(results_per_step, steps, domain)
    with open(os.path.join(out_path, "results.json"), "w") as fh:
        json.dump(results, fh)
    return results


def build_parser(topk_default: Optional[List[int]] = None) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Zero-shot DomainNet-LSO evaluation (PyTorch/CUDA port).")
    parser.add_argument("--model", type=str, required=True, help="CLIP model type")
    parser.add_argument("--domain", type=str, required=True, choices=EVAL_DOMAINS)
    parser.add_argument("--ckpt_files", type=str, nargs="+", required=True, help="checkpoints to evaluate")
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--imagenet_path", type=str, required=True)
    parser.add_argument("--domainnet_path", type=str, required=True)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--domain_invariant", action="store_true")
    parser.add_argument("--precision", type=str, default="fp32", choices=["fp32", "bf16", "fp16"],
                        help="eval encoder precision; fp16 computes and scores in IEEE half")
    parser.add_argument("--topk", type=int, nargs="+", default=topk_default,
                        help="also report these top-k accuracies and the macro F1 scores")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None, topk_default: Optional[List[int]] = None) -> int:
    args = build_parser(topk_default).parse_args(argv)
    disable_tf32()
    run_lso_evaluation(
        args.model, args.ckpt_files, args.out_path, args.imagenet_path, args.domainnet_path,
        args.domain, domain_invariant=args.domain_invariant, num_workers=args.num_workers,
        topk=args.topk, precision=args.precision, device=args.device,
    )
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
