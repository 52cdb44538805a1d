"""DomainNet-LSO evaluation protocol: the metrics stage.

A copy of ``xclip_tpu/evals/lso.py`` (numpy only): the 15 fixed
leave-some-out classes, top-1 accuracy for {domain, real} x {lso-id,
lso-ood, per-class-ood, unweighted-id, unweighted-ood} plus imagenet-val
total (or DomainNet alone, the supervised protocol), top-k accuracy, the
per-step merge into the ``results.json`` layout, and the prediction
``.npy`` files; plus :func:`f1_macro`, the macro F1 of
``sklearn.metrics.f1_score(average="macro")`` that the JAX top-k
evaluator calls, in numpy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

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


def top_k_accuracy(scores: np.ndarray, y_true: np.ndarray, k: int) -> float:
    """Top-k accuracy from an (N, C) score matrix (the same
    ``np.argpartition`` as the JAX evaluator, so ties resolve alike)."""
    topk = np.argpartition(-scores, kth=min(k, scores.shape[1] - 1), axis=1)[:, :k]
    return float(np.mean([y in row for y, row in zip(y_true, topk)]))


def f1_macro(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Macro-averaged F1 as ``sklearn.metrics.f1_score(y_true, y_pred,
    average="macro")``: over the sorted union of the labels in ``y_true``
    and ``y_pred``, each label's ``2 tp / (2 tp + fp + fn)``, 0 where that
    denominator is 0, then the unweighted mean."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    if labels.size == 0:
        return 0.0
    t, p = np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)
    tp = np.bincount(t[y_true == y_pred], minlength=labels.size).astype(np.float64)
    denom = (np.bincount(t, minlength=labels.size) + np.bincount(p, minlength=labels.size)).astype(np.float64)
    f1 = np.divide(2.0 * tp, denom, out=np.zeros_like(tp), where=denom != 0)
    return float(np.average(f1))


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
    val_labels: Optional[np.ndarray] = None,
    val_pred: Optional[np.ndarray] = None,
    domain_labels: np.ndarray,
    domain_pred: np.ndarray,
    domain_ids: np.ndarray,
    domain: str,
    domainnet_classes: Dict[int, str],
    class_to_idx: Dict[str, int] = LSO_CLASS_TO_IDX,
) -> Dict:
    """Metrics of one checkpoint from its predictions (``lso.evaluate_lso``).
    ``val_labels``/``val_pred`` come together or not at all: the supervised
    protocol passes neither, and ``imagenet-val`` is then empty."""
    if (val_labels is None) != (val_pred is None):
        raise ValueError("val_labels and val_pred must be provided together")
    res = {
        "imagenet-val": {"accuracy": {} if val_labels is None else {"total": accuracy_score(val_labels, val_pred)}},
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
        lso_mask = np.isin(kw_labels, list(class_to_idx.values()))
        if np.all(lso_mask):
            raise ValueError(f"{dom}: every sample is of an LSO class")

        acc[f"{dom}-lso-ood"] = accuracy_score(kw_labels[lso_mask], gen_pred[lso_mask])
        acc[f"{dom}-lso-id"] = accuracy_score(kw_labels[~lso_mask], gen_pred[~lso_mask])
        nums[f"{dom}-lso-ood"] = int(lso_mask.sum())
        nums[f"{dom}-lso-id"] = int((~lso_mask).sum())

        for cls, cls_idx in class_to_idx.items():
            cls_mask = kw_labels == cls_idx
            acc[f"{dom}-{cls}-ood"] = accuracy_score(kw_labels[cls_mask], gen_pred[cls_mask])
            nums[f"{dom}-{cls}-ood"] = int(cls_mask.sum())

        id_accs, ood_accs = [], []
        for label, cls in domainnet_classes.items():
            if cls in class_to_idx and label != class_to_idx[cls]:
                raise ValueError(f"class {cls!r} has label {label}, expected {class_to_idx[cls]}")
            cls_mask = kw_labels == label
            if not np.any(cls_mask):
                # one painting class has no val samples
                if domain != "painting":
                    raise ValueError(f"{dom}: class {cls!r} has no samples")
                continue
            bucket = ood_accs if cls in class_to_idx else id_accs
            bucket.append(accuracy_score(kw_labels[cls_mask], gen_pred[cls_mask]))

        acc[f"{dom}-lso-unweighted-id"] = float(np.mean(id_accs))
        acc[f"{dom}-lso-unweighted-ood"] = float(np.mean(ood_accs))

    return res


def merge_step_results(results_per_step: List[Dict], steps: List[int], domain: str,
                       classes: Optional[List[str]] = None) -> Dict:
    """Stack per-step metric dicts into the ``results.json`` layout."""
    results: Dict = {
        "steps": steps,
        "classes": classes if classes is not None else list(LSO_CLASS_TO_IDX),
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
