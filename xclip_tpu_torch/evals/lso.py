"""DomainNet-LSO zero-shot evaluation protocol: the metrics stage.

A copy of ``xclip_tpu/evals/lso.py`` (numpy only): the 15 fixed
leave-some-out classes, top-1 accuracy for {domain, real} x {lso-id,
lso-ood, per-class-ood, unweighted-id, unweighted-ood} plus imagenet-val
total, the per-step merge into the ``results.json`` layout, and the
prediction ``.npy`` files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from xclip_tpu_torch.data.datasets import DOMAIN_TO_IDX

LSO_CLASS_TO_IDX = {
    "aircraft carrier": 0,
    "axe": 11,
    "banana": 13,
    "barn": 15,
    "bed": 25,
    "candle": 58,
    "lion": 174,
    "mountain": 190,
    "necklace": 197,
    "penguin": 218,
    "pizza": 225,
    "saxophone": 250,
    "television": 305,
    "tractor": 319,
    "traffic light": 320,
}


def accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if y_true.size else float("nan")


def domainnet_classes_from_samples(samples: Sequence[Tuple[str, int, str]]) -> Dict[int, str]:
    """label -> human classname, derived from sample paths."""
    classes: Dict[int, str] = {}
    for path, label, _ in samples:
        *_, clss, _ = path.split("/")
        classes[label] = clss.replace("_", " ")
    return classes


def domain_ids_from_samples(samples: Sequence[Tuple[str, int, str]]) -> np.ndarray:
    return np.array([DOMAIN_TO_IDX[s[0].split("/")[-3]] for s in samples])


def evaluate_lso(
    *,
    val_labels: np.ndarray,
    val_pred: np.ndarray,
    domain_labels: np.ndarray,
    domain_pred: np.ndarray,
    domain_ids: np.ndarray,
    domain: str,
    domainnet_classes: Dict[int, str],
) -> Dict:
    """Metrics of one checkpoint from its predictions (``lso.evaluate_lso``)."""
    res = {
        "imagenet-val": {"accuracy": {"total": accuracy_score(val_labels, val_pred)}},
        "domainnet-val": {"accuracy": {}, "num-samples": {}},
    }
    acc = res["domainnet-val"]["accuracy"]
    nums = res["domainnet-val"]["num-samples"]

    for dom in [domain, "real"]:
        dom_mask = domain_ids == DOMAIN_TO_IDX[dom]
        kw_labels = domain_labels[dom_mask]
        if kw_labels.size == 0:
            raise ValueError(f"no DomainNet samples of domain {dom!r}")
        gen_pred = domain_pred[dom_mask]
        lso_mask = np.isin(kw_labels, list(LSO_CLASS_TO_IDX.values()))
        if np.all(lso_mask):
            raise ValueError(f"{dom}: every sample is of an LSO class")

        acc[f"{dom}-lso-ood"] = accuracy_score(kw_labels[lso_mask], gen_pred[lso_mask])
        acc[f"{dom}-lso-id"] = accuracy_score(kw_labels[~lso_mask], gen_pred[~lso_mask])
        nums[f"{dom}-lso-ood"] = int(lso_mask.sum())
        nums[f"{dom}-lso-id"] = int((~lso_mask).sum())

        for cls, cls_idx in LSO_CLASS_TO_IDX.items():
            cls_mask = kw_labels == cls_idx
            acc[f"{dom}-{cls}-ood"] = accuracy_score(kw_labels[cls_mask], gen_pred[cls_mask])
            nums[f"{dom}-{cls}-ood"] = int(cls_mask.sum())

        id_accs, ood_accs = [], []
        for label, cls in domainnet_classes.items():
            if cls in LSO_CLASS_TO_IDX and label != LSO_CLASS_TO_IDX[cls]:
                raise ValueError(f"class {cls!r} has label {label}, expected {LSO_CLASS_TO_IDX[cls]}")
            cls_mask = kw_labels == label
            if not np.any(cls_mask):
                # one painting class has no val samples
                if domain != "painting":
                    raise ValueError(f"{dom}: class {cls!r} has no samples")
                continue
            bucket = ood_accs if cls in LSO_CLASS_TO_IDX else id_accs
            bucket.append(accuracy_score(kw_labels[cls_mask], gen_pred[cls_mask]))

        acc[f"{dom}-lso-unweighted-id"] = float(np.mean(id_accs))
        acc[f"{dom}-lso-unweighted-ood"] = float(np.mean(ood_accs))

    return res


def merge_step_results(results_per_step: List[Dict], steps: List[int], domain: str) -> Dict:
    """Stack per-step metric dicts into the ``results.json`` layout."""
    results: Dict = {
        "steps": steps,
        "classes": list(LSO_CLASS_TO_IDX),
        "domain": domain,
        "imagenet-val": {"accuracy": {}},
        "domainnet-val": {"accuracy": {}, "num-samples": {}},
    }
    for result in results_per_step:
        for metric in ("imagenet-val", "domainnet-val"):
            for split in result[metric]:
                results[metric].setdefault(split, {})
                for feature, val in result[metric][split].items():
                    results[metric][split].setdefault(feature, []).append(val)
    return results


def serialize_predictions(predictions: List[Tuple], out_path: str) -> None:
    """Save stacked predictions across checkpoints."""
    val_labels, val_pred, domain_labels, domain_pred, domain_ids = zip(*predictions)
    for name, cols in (("val_labels", val_labels), ("domain_labels", domain_labels),
                       ("domain_ids", domain_ids)):
        if not all(np.array_equal(c, cols[0]) for c in cols):
            raise ValueError(f"{name} differ between checkpoints")
    os.makedirs(out_path, exist_ok=True)
    np.save(os.path.join(out_path, "val_labels.npy"), np.array(val_labels[0]))
    np.save(os.path.join(out_path, "val_pred.npy"), np.array(val_pred))
    np.save(os.path.join(out_path, "domain_labels.npy"), np.array(domain_labels[0]))
    np.save(os.path.join(out_path, "domain_pred.npy"), np.array(domain_pred))
    np.save(os.path.join(out_path, "domain_ids.npy"), np.array(domain_ids[0]))


def epoch_or_step_from_ckpt_file(filename: str) -> int:
    """Checkpoint series ordering key (``epoch_N.pt`` / ``..._step_N.pt``)."""
    filename = os.path.basename(filename)
    begin = filename.find("step") + 5 if "step" in filename else filename.find("epoch") + 6
    end = filename.find(".")
    return int(filename[begin:end])
