"""Circuit similarity across domains, paper Fig. 6c.

Counterpart of ``scripts/compute_circuit_similarity.py``, with its flags:
per class, a top-``--edge_k``-edge DAG of each domain's circuit
(``compute_circuits``), and the edge-set Jaccard (``--metric jaccard``) or
the Weisfeiler-Lehman kernel (``--metric wl``) of each pair of domains,
averaged per split into ``<out_path>/circuit_similarity_{metric}.json``.
numpy and the port's own graph class (no networkx)::

    python -m xclip_tpu_torch.scripts.compute_circuit_similarity --model_dir runs/rn50 \\
        --out_path sims/ --metric wl
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Optional, Sequence

import numpy as np

from xclip_tpu_torch.data.datasets import ALL_DOMAINS
from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX
from xclip_tpu_torch.interp.graph import build_circuit_graph, jaccard_graph_similarity, wl_kernel_similarity


def load_npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_graph(circuit_dir, domain, label, edge_k):
    base = os.path.join(circuit_dir, domain)
    nodes = load_npz(os.path.join(base, f"{label}_nodes.npz"))
    features = load_npz(os.path.join(base, f"{label}_features_by_submod.npz"))
    edges = {}
    for key, val in load_npz(os.path.join(base, f"{label}_edges.npz")).items():
        parent, child = key.split("->")
        edges.setdefault(parent, {})[child] = val
    return build_circuit_graph(nodes, edges, features, edge_k=edge_k)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--metric", type=str, default="jaccard", choices=["jaccard", "wl"])
    parser.add_argument("--edge_k", type=int, default=3)
    parser.add_argument("--wl_iterations", type=int, default=3)
    args = parser.parse_args(argv)

    circuit_dir = os.path.join(args.model_dir, "circuit_analysis")
    files = sorted(f for f in os.listdir(os.path.join(circuit_dir, "real")) if f.endswith("_edges.npz"))
    labels = [int(f.split("_")[0]) for f in files]
    ood = set(LSO_CLASS_TO_IDX.values())

    results = {"all": {}, "ood": {}, "id": {}}
    for label in labels:
        graphs = {}
        for domain in ALL_DOMAINS:
            if os.path.isfile(os.path.join(circuit_dir, domain, f"{label}_edges.npz")):
                graphs[domain] = load_graph(circuit_dir, domain, label, args.edge_k)
        if args.metric == "wl":
            doms = list(graphs)
            sim = wl_kernel_similarity([graphs[d] for d in doms], h=args.wl_iterations)
            pair_scores = {f"{a}|{b}": float(sim[i, j]) for i, a in enumerate(doms)
                           for j, b in enumerate(doms) if i < j}
        else:
            pair_scores = {f"{a}|{b}": jaccard_graph_similarity(graphs[a], graphs[b])
                           for a, b in itertools.combinations(graphs, r=2)}
        for bucket in ["all", "ood" if label in ood else "id"]:
            for pair, score in pair_scores.items():
                results[bucket].setdefault(pair, []).append(score)

    summary = {split: {pair: float(np.mean(v)) for pair, v in pairs.items()} for split, pairs in results.items()}
    os.makedirs(args.out_path, exist_ok=True)
    with open(os.path.join(args.out_path, f"circuit_similarity_{args.metric}.json"), "w") as fh:
        json.dump(summary, fh)
    for split, pairs in summary.items():
        if pairs:
            print(f"{split}: mean circuit similarity {np.mean(list(pairs.values())):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
