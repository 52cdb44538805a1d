"""Interpretability: feature circuits, CKA and SAE feature sharing
(counterpart of ``xclip_tpu/interp``, with the same exports)."""

from xclip_tpu_torch.interp.attribution import EffectOut, patching_effect, upstream_neuron_attribution  # noqa: F401
from xclip_tpu_torch.interp.cka import hsic0, hsic1, kernel_cka, linear_cka  # noqa: F401
from xclip_tpu_torch.interp.circuit_model import VisualCircuitModel  # noqa: F401
from xclip_tpu_torch.interp.circuits import compute_class_circuit, compute_edges, compute_nodes  # noqa: F401
from xclip_tpu_torch.interp.dictionary import Dictionary, IdentityDict, SAEDictionary  # noqa: F401
from xclip_tpu_torch.interp.feature_sharing import evaluate_feature_sharing, mpct_shared, pct_shared  # noqa: F401
from xclip_tpu_torch.interp.graph import (  # noqa: F401
    build_circuit_graph,
    jaccard_graph_similarity,
    node_jaccard_similarity,
    wl_kernel_similarity,
)
from xclip_tpu_torch.interp.sparse_act import SparseAct  # noqa: F401
