"""SAE feature-sharing analysis (paper Fig. 4).

Counterpart of ``xclip_tpu/interp/feature_sharing.py`` (the reference's
``analyze_sae_features.py:60-137``): per class and domain, a histogram of
how often each SAE feature is among a sample's top 20 active ones;
``mpct_shared`` is the mean top-k index overlap for k in {5, 10, 15, 20};
the 6 x 6 domain matrix's off-diagonal row mean is the sharing score. The
SAE encodes each group in one batched call on the parameters' device; the
top-k and the histograms are numpy on the host, as in JAX.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from xclip_tpu_torch.data.datasets import ALL_DOMAINS, DOMAIN_TO_IDX
from xclip_tpu_torch.sae.model import sae_apply


def pct_shared(hist_a: np.ndarray, hist_b: np.ndarray, k: int = 10) -> float:
    a = set(np.argsort(-hist_a)[:k].tolist())
    b = set(np.argsort(-hist_b)[:k].tolist())
    return len(a & b) / k


def mpct_shared(hist_a, hist_b, ks=(5, 10, 15, 20)) -> float:
    return sum(pct_shared(hist_a, hist_b, k) for k in ks) / len(ks)


@torch.no_grad()
def sae_concepts(sae_params: Dict, x) -> np.ndarray:
    """The SAE's learned activations of features ``x`` (N, d) -> (N, m) numpy."""
    x = torch.as_tensor(np.asarray(x, np.float32), device=sae_params["tied_bias"].device)
    if sae_params["encoder"]["weight"].dim() == 3:  # a components axis: JAX's einsum broadcasts (N, d) over it
        x = x[:, None, :]
    learned, _ = sae_apply(sae_params, x)
    if learned.dim() == 3:
        learned = learned[:, 0]
    return learned.cpu().numpy()


def top20_histograms(sae_params: Dict, img_feat: np.ndarray, domain_labels: np.ndarray, domain_ids: np.ndarray,
                     class_to_idx: Dict[str, int], n_learned_features: int = 4096,
                     top_k: int = 20) -> Dict[str, List[np.ndarray]]:
    """Per class x domain: counts of how often each SAE feature appears in a
    sample's top-20 active set (counted when its activation is > 0)."""
    histograms: Dict[str, List[np.ndarray]] = {}
    domains_present = np.unique(domain_ids)
    for cls, cls_idx in class_to_idx.items():
        cls_mask = domain_labels == cls_idx
        histograms[cls] = [np.zeros(n_learned_features) for _ in range(len(ALL_DOMAINS))]
        for dom in domains_present:
            mask = cls_mask & (domain_ids == dom)
            if not np.any(mask):
                continue
            learned = sae_concepts(sae_params, img_feat[mask])
            idx = np.argsort(-learned, axis=1)[:, :top_k]
            vals = np.take_along_axis(learned, idx, axis=1)
            hist = histograms[cls][int(dom)]
            for row_idx, row_vals in zip(idx, vals):
                hist[row_idx[row_vals > 0]] += 1
    return histograms


def evaluate_feature_sharing(sae_params: Dict, img_feat: np.ndarray, domain_labels: np.ndarray,
                             domain_ids: np.ndarray, class_to_idx: Dict[str, int], domain: str,
                             out_path: Optional[str] = None, n_learned_features: int = 4096) -> Dict:
    """Full protocol -> the feature-sharing.json layout (reference :72-137)."""
    histograms = top20_histograms(sae_params, img_feat, domain_labels, domain_ids, class_to_idx,
                                  n_learned_features)

    if out_path:
        os.makedirs(out_path, exist_ok=True)
        for cls in class_to_idx:
            for dom_name, dom_idx in DOMAIN_TO_IDX.items():
                np.save(os.path.join(out_path, f"{cls}_{dom_name}_hist.npy"), histograms[cls][dom_idx])

    results: Dict = {}
    for cls in class_to_idx:
        results[cls] = {"mpct_shared@20": [[mpct_shared(a, b) for b in histograms[cls]] for a in histograms[cls]]}
    results["avg"] = {"mpct_shared@20": [
        [[mpct_shared(a, b) for b in histograms[cls]] for a in histograms[cls]] for cls in class_to_idx]}
    results["score"] = {}
    for key, val in results["avg"].items():
        m = np.mean(np.array(val), axis=0)
        results["avg"][key] = m.tolist()
        scores = np.delete(m[DOMAIN_TO_IDX[domain]], DOMAIN_TO_IDX[domain])
        results["score"][key] = float(np.mean(scores))

    if out_path:
        with open(os.path.join(out_path, "feature-sharing.json"), "w") as fh:
            json.dump(results, fh)
    return results
