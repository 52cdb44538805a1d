"""Circuit graphs and their similarity measures, without networkx or graphviz.

Counterpart of ``xclip_tpu/interp/graph.py`` (the reference's
``graph_utility.py:18-179``, ``compute_node_similarity.py:141-200`` and
``compute_circuit_similarity.py:71-140``): a DAG with the top-``edge_k``
edges per (parent, child) stage pair, per-stage Jaccard of the top-10 %
neurons, edge-set Jaccard and the Weisfeiler-Lehman graph kernel.

The machine with the card has neither ``networkx`` nor ``graphviz``, so
:class:`DiGraph` is the port's own: nodes with attributes (``node_label``,
``effect``), weighted edges, and ``networkx.DiGraph``'s insertion order
(nodes in the order first added, an edge adding its missing ends tail
first; successors in the order their edges were added), on which the WL
labels depend. :func:`render_circuit_graphviz` writes the DOT source that
``graphviz.Digraph`` would (JAX saves that source when graphviz's
binaries are absent, ``graph.py:165-170``); ``dot -Tpdf`` renders it.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List

import numpy as np


class DiGraph:
    """Directed graph with ordered nodes and successors (the parts of
    ``networkx.DiGraph`` that the circuit code uses)."""

    def __init__(self):
        self._nodes: Dict[str, dict] = {}
        self._succ: Dict[str, Dict[str, dict]] = {}
        self._pred: Dict[str, Dict[str, dict]] = {}

    def add_node(self, node: str, **attr) -> None:
        if node not in self._nodes:
            self._nodes[node] = {}
            self._succ[node] = {}
            self._pred[node] = {}
        self._nodes[node].update(attr)

    def add_edge(self, u: str, v: str, **attr) -> None:
        self.add_node(u)
        self.add_node(v)
        data = self._succ[u].setdefault(v, {})
        data.update(attr)
        self._pred[v][u] = data

    def nodes(self, data: bool = False) -> List:
        return list(self._nodes.items()) if data else list(self._nodes)

    def node_attrs(self, node: str) -> dict:
        return self._nodes[node]

    def edges(self, data: bool = False) -> List:
        return [(u, v, d) if data else (u, v) for u, nbrs in self._succ.items() for v, d in nbrs.items()]

    def neighbors(self, node: str) -> List[str]:
        """Successors, in the order their edges were added."""
        return list(self._succ[node])

    def degree(self, node: str) -> int:
        return len(self._succ[node]) + len(self._pred[node])

    def number_of_nodes(self) -> int:
        return len(self._nodes)

    def number_of_edges(self) -> int:
        return sum(len(n) for n in self._succ.values())


def build_circuit_graph(nodes: Dict[str, np.ndarray], edges: Dict[str, Dict[str, np.ndarray]],
                        features_by_submod: Dict[str, np.ndarray], edge_k: int = 3) -> DiGraph:
    """DAG with the top-|edge_k| edges per (parent, child) pair, nodes named
    '{layer}/{neuron}' (reference create_dag semantics)."""
    g = DiGraph()
    for layer_name, per_channel in nodes.items():
        if layer_name == "input":
            continue
        for neuron in np.asarray(features_by_submod[layer_name]).tolist():
            g.add_node(f"{layer_name}/{neuron}", node_label=str(neuron),
                       effect=float(np.asarray(per_channel)[neuron]))

    for parent, children in edges.items():
        if parent == "input":
            continue
        p_feats = np.asarray(features_by_submod[parent])
        for child, weight in children.items():
            w = np.asarray(weight)  # (n_down, n_up)
            c_feats = np.asarray(features_by_submod[child])
            k = min(edge_k, w.size)
            for fi in np.argsort(-np.abs(w), axis=None)[:k]:
                d_i, u_i = np.unravel_index(fi, w.shape)
                g.add_edge(f"{parent}/{p_feats[u_i]}", f"{child}/{c_feats[d_i]}", weight=float(w[d_i, u_i]))
    return g


def jaccard_graph_similarity(g1: DiGraph, g2: DiGraph) -> float:
    """Edge-set Jaccard (reference compute_circuit_similarity.py:71-79)."""
    e1, e2 = set(g1.edges()), set(g2.edges())
    union = len(e1 | e2)
    return len(e1 & e2) / union if union else 0.0


def node_jaccard_similarity(nodes_a: np.ndarray, nodes_b: np.ndarray, fraction: float = 0.1) -> float:
    """Jaccard of the top-fraction most important neurons by |effect|
    (reference compute_node_similarity.py:171-178)."""
    n = np.asarray(nodes_a).shape[0]
    k = math.ceil(n * fraction)
    a = set(np.argsort(np.abs(np.asarray(nodes_a)))[-k:].tolist())
    b = set(np.argsort(np.abs(np.asarray(nodes_b)))[-k:].tolist())
    return len(a & b) / len(a | b)


def wl_kernel_similarity(graphs: List[DiGraph], h: int = 3, node_label: bool = True) -> np.ndarray:
    """Weisfeiler-Lehman graph-kernel similarity matrix (normalized), the
    GK_WL.compare_list equivalent (reference compute_circuit_similarity.py:
    85-260, after emanuele/jstsp2015)."""
    n = len(graphs)
    node_order = [g.nodes() for g in graphs]
    adjacency = [[g.neighbors(v) for v in g.nodes()] for g in graphs]
    label_lookup: Dict = {}

    def lab_id(lab):
        if lab not in label_lookup:
            label_lookup[lab] = len(label_lookup)
        return label_lookup[lab]

    labels = []
    for gi, g in enumerate(graphs):
        if node_label:
            labels.append(np.array([lab_id(g.node_attrs(v).get("node_label", str(v))) for v in node_order[gi]]))
        else:
            labels.append(np.array([lab_id(str(g.degree(v))) for v in node_order[gi]]))

    def phi_matrix(labels_list):
        phi = np.zeros((len(label_lookup), n), dtype=np.float64)
        for gi, labs in enumerate(labels_list):
            for lab in labs:
                phi[lab, gi] += 1
        return phi

    k = phi_matrix(labels).T @ phi_matrix(labels)
    for _ in range(h):
        new_labels = []
        for gi in range(n):
            index_of = {v: i for i, v in enumerate(node_order[gi])}
            labs = []
            for vi, v in enumerate(node_order[gi]):
                neigh = sorted(labels[gi][index_of[u]] for u in adjacency[gi][vi])
                labs.append(lab_id((int(labels[gi][vi]), tuple(int(x) for x in neigh))))
            new_labels.append(np.array(labs))
        labels = new_labels
        phi = phi_matrix(labels)
        k = k + phi.T @ phi

    diag = np.sqrt(np.outer(np.diag(k), np.diag(k)))
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(diag > 0, k / diag, 0.0)


# DOT quoting as graphviz.quoting.quote does it (no HTML labels here)
_DOT_ID = re.compile(r"([a-zA-Z_][a-zA-Z0-9_]*|-?(\.[0-9]+|[0-9]+(\.[0-9]*)?))$")
_DOT_KEYWORDS = {"node", "edge", "graph", "digraph", "subgraph", "strict"}
_UNESCAPED_QUOTE = re.compile(r'(?P<escaped_backslashes>(?<!\\)(?:\\{2})*)(?P<literal_quote>")')


def _quote(identifier: str) -> str:
    if not _DOT_ID.match(identifier) or identifier.lower() in _DOT_KEYWORDS:
        return '"' + _UNESCAPED_QUOTE.sub(r'\g<escaped_backslashes>\\\g<literal_quote>', identifier) + '"'
    return identifier


def _attr_list(items: Iterable, label=None) -> str:
    parts = [f"label={_quote(label)}"] if label is not None else []
    parts += [f"{_quote(k)}={_quote(v)}" for k, v in sorted(items)]
    return f" [{' '.join(parts)}]" if parts else ""


def render_circuit_graphviz(g: DiGraph, out_path: str, *, pen_thickness: float = 3.0) -> str:
    """Write the circuit DAG's DOT source to ``out_path + ".dot"`` (reference
    plot_graphviz_dag / create_dag rendering): nodes coloured by signed
    effect magnitude (blue positive, red negative), edge pen width by
    |weight|. Returns the written path; ``dot -Tpdf`` renders it."""
    effects = [abs(d.get("effect", 0.0)) for _, d in g.nodes(data=True)]
    scale = max(effects) if effects else 1.0
    weights = [abs(d.get("weight", 0.0)) for *_, d in g.edges(data=True)]
    wscale = max(weights) if weights else 1.0

    def to_hex(number: float):
        number = number / scale if scale else 0.0
        if number < 0:
            red, green = 255, int((1 + number) * 255)
            blue = green
        elif number > 0:
            blue = 255
            red = green = int((1 - number) * 255)
        else:
            red = green = blue = 255
        text = "#000000" if (red * 0.299 + green * 0.587 + blue * 0.114) > 170 else "#ffffff"
        return f"#{red:02X}{green:02X}{blue:02X}", text

    lines = [f"digraph {_quote('Feature circuit')} {{",
             "\tgraph" + _attr_list({"rankdir": "BT", "newrank": "true"}.items()),
             "\tnode" + _attr_list({"shape": "box", "style": "rounded,filled"}.items())]
    for node, data in g.nodes(data=True):
        fill, text = to_hex(data.get("effect", 0.0))
        lines.append(f"\t{_quote(node)}" + _attr_list({"fillcolor": fill, "fontcolor": text}.items(), label=node))
    for u, v, data in g.edges(data=True):
        w = abs(data.get("weight", 0.0)) / wscale if wscale else 0.0
        lines.append(f"\t{_quote(u)} -> {_quote(v)}"
                     + _attr_list({"penwidth": str(max(0.3, w * pen_thickness))}.items()))
    path = out_path + ".dot"
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n}\n")
    return path
