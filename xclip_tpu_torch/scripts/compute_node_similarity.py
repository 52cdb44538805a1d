"""Node similarity across domains, paper Fig. 6b.

Counterpart of ``scripts/compute_node_similarity.py``, with its flags: per
submodule, the Jaccard of the top-10 % neurons of each pair of domains'
``{label}_nodes.npz`` (``compute_circuits``), averaged per split (all, ood,
id) into ``<out_path>/node_similarity.json``. numpy only::

    python -m xclip_tpu_torch.scripts.compute_node_similarity --model_dir runs/rn50 --out_path sims/
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
from xclip_tpu_torch.interp.graph import node_jaccard_similarity


def load_nodes(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    args = parser.parse_args(argv)

    circuit_dir = os.path.join(args.model_dir, "circuit_analysis")
    files = sorted(f for f in os.listdir(os.path.join(circuit_dir, "real")) if f.endswith("_nodes.npz"))
    ood_labels = set(LSO_CLASS_TO_IDX.values())

    buckets = {"all": {}, "ood": {}, "id": {}}
    for fname in files:
        label = int(fname.split("_")[0])
        for da, db in itertools.combinations(ALL_DOMAINS, r=2):
            pa, pb = os.path.join(circuit_dir, da, fname), os.path.join(circuit_dir, db, fname)
            if not (os.path.isfile(pa) and os.path.isfile(pb)):
                continue
            nodes_a, nodes_b = load_nodes(pa), load_nodes(pb)
            for layer in nodes_a:
                if layer == "input":
                    continue
                score = node_jaccard_similarity(nodes_a[layer], nodes_b[layer], fraction=0.1)
                for bucket in ["all", "ood" if label in ood_labels else "id"]:
                    buckets[bucket].setdefault(layer, {}).setdefault(f"{da}|{db}", []).append(score)

    results = {split: {layer: {pair: float(np.mean(v)) for pair, v in pairs.items()}
                       for layer, pairs in layers.items()}
               for split, layers in buckets.items()}
    os.makedirs(args.out_path, exist_ok=True)
    with open(os.path.join(args.out_path, "node_similarity.json"), "w") as fh:
        json.dump(results, fh)
    for split in results:
        vals = [v for layers in results[split].values() for v in layers.values()]
        if vals:
            print(f"{split}: mean node similarity {np.mean(vals):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
