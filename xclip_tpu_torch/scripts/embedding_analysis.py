"""Embedding-space analysis of cached features, paper Fig. 5.

Counterpart of ``scripts/embedding_analysis.py``, with its flags plus
``--device``. It reads ``img_feat.npy`` and ``domain_ids.npy`` from
``save_domainnet_features`` (the last checkpoint's features when the array
is (checkpoints, N, D)) and writes under ``--out_path``:

- ``embedding_analysis.json``: the inter-domain distance matrix of the
  domains' mean features, the 10 dimensions where quickdraw's mean differs
  most from the other domains' and the largest such difference, as JAX
  writes them;
- ``embedding.npy``: the densMAP 2-D embedding of at most ``--max_points``
  features (a seeded subsample), from the port's UMAP (``evals.umap``),
  the kNN and the layout on the device;
- ``embedding.png``, ``domain_distances.png`` and
  ``quickdraw_separation.png`` when matplotlib imports (it prints which it
  wrote, or that it wrote none)::

    python -m xclip_tpu_torch.scripts.embedding_analysis --features_path feats/ --out_path emb/

The device defaults to CUDA and must be present unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from xclip_tpu_torch.core.device import resolve_device
from xclip_tpu_torch.data.datasets import ALL_DOMAINS
from xclip_tpu_torch.evals.umap import umap_embed


def embed_2d(feats: np.ndarray, seed: int = 0, device: str = "cuda") -> np.ndarray:
    """densMAP 2-D embedding (the reference's ``umap.UMAP(densmap=True)``)."""
    return umap_embed(torch.as_tensor(np.asarray(feats, np.float32)).to(resolve_device(device)), densmap=True,
                      seed=seed)


def analysis_summary(img_feat: np.ndarray, domain_ids: np.ndarray):
    """(summary for the JSON, the domains' mean-feature distances, the
    per-dimension |quickdraw - rest| differences and their descending order)."""
    means = np.stack([
        img_feat[domain_ids == d].mean(axis=0) if np.any(domain_ids == d) else np.zeros(img_feat.shape[1])
        for d in range(len(ALL_DOMAINS))
    ])
    dists = np.linalg.norm(means[:, None] - means[None, :], axis=-1)
    qd = means[ALL_DOMAINS.index("quickdraw")]
    others = np.delete(means, ALL_DOMAINS.index("quickdraw"), axis=0).mean(axis=0)
    absdiff = np.abs(qd - others)
    order = np.argsort(-absdiff)
    summary = {
        "domain_distance_matrix": dists.tolist(),
        "quickdraw_top_dims": order[:10].tolist(),
        "quickdraw_max_absdiff": float(absdiff.max()),
    }
    return summary, dists, absdiff, order


def plot(out_path: str, emb: np.ndarray, emb_domains: np.ndarray, dists: np.ndarray, absdiff: np.ndarray,
         order: np.ndarray) -> list:
    """The three figures, as JAX draws them; [] when matplotlib is absent."""
    try:
        import matplotlib
    except ImportError:
        return []
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    for d_idx, d_name in enumerate(ALL_DOMAINS):
        mask = emb_domains == d_idx
        ax.scatter(emb[mask, 0], emb[mask, 1], s=2, label=d_name, alpha=0.5)
    ax.legend()
    fig.savefig(os.path.join(out_path, "embedding.png"), dpi=150)
    plt.close(fig)

    fig, ax = plt.subplots()
    im = ax.imshow(dists)
    ax.set_xticks(range(6), ALL_DOMAINS, rotation=45)
    ax.set_yticks(range(6), ALL_DOMAINS)
    fig.colorbar(im)
    fig.savefig(os.path.join(out_path, "domain_distances.png"), dpi=150, bbox_inches="tight")
    plt.close(fig)

    fig, ax = plt.subplots()
    ax.plot(absdiff[order])
    ax.set_xlabel("embedding dimension (sorted)")
    ax.set_ylabel("|mean difference| quickdraw vs rest")
    fig.savefig(os.path.join(out_path, "quickdraw_separation.png"), dpi=150)
    plt.close(fig)
    return ["embedding.png", "domain_distances.png", "quickdraw_separation.png"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--features_path", type=str, required=True,
                        help="directory with img_feat.npy etc. from save_domainnet_features")
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--max_points", type=int, default=20000)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    img_feat = np.load(os.path.join(args.features_path, "img_feat.npy"))
    domain_ids = np.load(os.path.join(args.features_path, "domain_ids.npy"))
    if img_feat.ndim == 3:  # (steps, N, D): the final checkpoint
        img_feat = img_feat[-1]
    os.makedirs(args.out_path, exist_ok=True)

    if args.max_points and len(img_feat) > args.max_points:
        idx = np.random.RandomState(0).permutation(len(img_feat))[: args.max_points]
        emb, emb_domains = embed_2d(img_feat[idx], device=args.device), domain_ids[idx]
    else:
        emb, emb_domains = embed_2d(img_feat, device=args.device), domain_ids
    np.save(os.path.join(args.out_path, "embedding.npy"), emb)

    summary, dists, absdiff, order = analysis_summary(img_feat, domain_ids)
    figures = plot(args.out_path, emb, emb_domains, dists, absdiff, order)
    print("figures: " + (", ".join(figures) if figures else "none (matplotlib is not installed)"))
    with open(os.path.join(args.out_path, "embedding_analysis.json"), "w") as fh:
        json.dump(summary, fh)
    print(json.dumps({"quickdraw_max_absdiff": summary["quickdraw_max_absdiff"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
