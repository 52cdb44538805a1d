"""Circuit computation: node effects and backward pairwise edge effects.

Counterpart of ``xclip_tpu/interp/circuits.py`` (the reference's
``circuit.py``: ``compute_nodes`` :18-70, per-submodule IG effects summed
over space and averaged over the batch, and ``compute_edges_new``
:224-278, the backward loop over adjacent stage pairs), driven per domain
and class by ``scripts/compute_circuits.py``: the top ``node_threshold``
fraction of channels per stage, saved as ``{label}_nodes.npz``,
``{label}_features_by_submod.npz`` and ``{label}_edges.npz`` (keys
``"{prev}->{cur}"``), the same files with the same keys as JAX's. The top
channels are chosen by ``np.argsort`` on host copies, as JAX chooses them.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np

from xclip_tpu_torch.interp.attribution import patching_effect, upstream_neuron_attribution
from xclip_tpu_torch.interp.dictionary import Dictionary, IdentityDict


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def compute_nodes(images, patch, model, submodules: Sequence[str], dictionaries: Dict[str, Dictionary],
                  metric_label: int, aggregation: str = "sum", steps: int = 10):
    """Returns (nodes, (effects, deltas, grads, total_effect)); nodes[name]
    is the per-channel SparseAct effect aggregated sum(spatial).mean(batch)."""
    effects, deltas, grads, total_effect = patching_effect(
        images, patch, model, submodules, dictionaries, metric_label, method="ig", steps=steps)
    nodes = {"y": total_effect}
    for name in submodules:
        nodes[name] = effects[name]
    if aggregation == "sum":
        for k in nodes:
            if k != "y" and nodes[k] is not None:
                nodes[k] = nodes[k].sum(axis=1)
    nodes = {k: v.mean(axis=0) for k, v in nodes.items() if k != "y" and v is not None}
    return nodes, (effects, deltas, grads, total_effect)


def select_top_features(effects, submodules: Sequence[str], node_threshold: float = 0.1) -> Dict[str, np.ndarray]:
    """Top ceil(C * node_threshold) channels per stage by |effect|
    (reference compute_circuits.py:327-339)."""
    features = {}
    for name in submodules:
        eff = _np(effects[name].sum(axis=1).mean(axis=0).abs().act)
        k = math.ceil(eff.shape[-1] * node_threshold)
        features[name] = np.argsort(-eff)[:k]
    return features


def compute_edges(images, patch, model, submodules: Sequence[str], dictionaries: Dict[str, Dictionary],
                  features_by_submod: Dict[str, np.ndarray], steps: int = 10) -> Dict[str, Dict[str, np.ndarray]]:
    """Backward pairwise edge effects (reference compute_edges_new)."""
    edges: Dict[str, Dict[str, np.ndarray]] = {}
    for layer in reversed(range(1, len(submodules))):
        cur, prev = submodules[layer], submodules[layer - 1]
        edges.setdefault(prev, {})[cur] = upstream_neuron_attribution(
            images, patch, model, prev, cur, dictionaries,
            upstream_neurons=features_by_submod[prev], downstream_neurons=features_by_submod[cur],
            steps=steps)
    return edges


def compute_class_circuit(model, images, label: int, *, node_threshold: float = 0.1, steps: int = 10,
                          dictionaries: Optional[Dict[str, Dictionary]] = None,
                          out_folder: Optional[str] = None, compute_edge_effects: bool = True):
    """Full per-class protocol (reference compute_circuits.py:262-397):
    nodes -> top-threshold feature selection -> pairwise edges; artifacts
    saved as {label}_nodes.npz / _features_by_submod.npz / _edges.npz."""
    submodules = [s.name for s in model.stages]
    if dictionaries is None:
        dictionaries = {s.name: IdentityDict(s.channels) for s in model.stages}
    images = model.as_input(images)

    nodes, (effects, _, _, _) = compute_nodes(images, None, model, submodules, dictionaries, label,
                                              steps=steps)
    features = select_top_features(effects, submodules, node_threshold)

    edges = None
    if compute_edge_effects:
        edges = compute_edges(images, None, model, submodules, dictionaries, features, steps=steps)

    if out_folder:
        os.makedirs(out_folder, exist_ok=True)
        np.savez(os.path.join(out_folder, f"{label}_nodes.npz"), **{k: _np(v.act) for k, v in nodes.items()})
        np.savez(os.path.join(out_folder, f"{label}_features_by_submod.npz"), **features)
        if edges is not None:
            flat = {f"{p}->{c}": e for p, d in edges.items() for c, e in d.items()}
            np.savez(os.path.join(out_folder, f"{label}_edges.npz"), **flat)
    return nodes, features, edges
