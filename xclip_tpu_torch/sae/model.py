"""Sparse autoencoder: tied bias -> ReLU encoder -> unit-norm decoder.

Counterpart of ``xclip_tpu/sae/model.py``. Parameters are a dict of fp32
tensors with the JAX pytree's layout, so the two packages trade them as
arrays::

    {"tied_bias": ([C,] d), "encoder": {"weight": ([C,] m, d), "bias": ([C,] m)},
     "decoder": {"weight": ([C,] d, m)}}

The optional leading components axis ``C`` is ``SAECfg.n_components``; the
SAE CLI sets it to the number of hook points (1 by default), so there
activations are (batch, 1, d). ``sae_init`` draws from a ``torch.Generator``
with the JAX package's distributions (not its numbers: ``jax.random`` cannot
be reproduced); ``sae_params_from_numpy`` carries JAX's parameters across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

Params = Dict[str, Union[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class SAECfg:
    n_input_features: int
    n_learned_features: int
    n_components: Optional[int] = None


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], params: Mapping) -> Params:
    """Apply ``fn`` to every tensor of a params-shaped dict."""
    return {k: tree_map(fn, v) if isinstance(v, Mapping) else fn(v) for k, v in params.items()}


def tree_leaves(params: Mapping):
    """The tensors of a params-shaped dict, in key order."""
    out = []
    for v in params.values():
        out.extend(tree_leaves(v) if isinstance(v, Mapping) else [v])
    return out


def sae_init(generator: torch.Generator, cfg: SAECfg, device: Union[str, torch.device] = "cpu") -> Params:
    """Kaiming-uniform encoder (bound sqrt(6/d)), encoder bias U(+-1/sqrt(d)),
    decoder U(+-sqrt(6/m)) with unit-norm columns, tied bias zero. Drawn on
    the CPU from ``generator``, then moved."""
    c = () if cfg.n_components is None else (cfg.n_components,)
    d, m = cfg.n_input_features, cfg.n_learned_features

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator, dtype=torch.float32) * 2.0 - 1.0) * bound

    enc_w = uniform((*c, m, d), math.sqrt(6.0 / d))
    enc_b = uniform((*c, m), 1.0 / math.sqrt(d))
    dec_w = uniform((*c, d, m), math.sqrt(6.0 / m))
    dec_w = dec_w / torch.linalg.vector_norm(dec_w, dim=-2, keepdim=True)
    params = {"tied_bias": torch.zeros((*c, d), dtype=torch.float32), "encoder": {"weight": enc_w, "bias": enc_b}, "decoder": {"weight": dec_w}}
    return tree_map(lambda t: t.to(device), params)


def _encode(centered: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    # "...d,...md->...m"
    if weight.dim() == 2:
        return centered @ weight.t()
    return torch.einsum("bcd,cmd->bcm", centered, weight)


def _decode(learned: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    # "...m,...dm->...d"
    if weight.dim() == 2:
        return learned @ weight.t()
    return torch.einsum("bcm,cdm->bcd", learned, weight)


def sae_apply(params: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass -> (learned_activations, decoded_activations); ``x`` is
    (batch, [components,] d), fp32 products."""
    tied = params["tied_bias"]
    learned = torch.relu(_encode(x - tied, params["encoder"]["weight"]) + params["encoder"]["bias"])
    return learned, _decode(learned, params["decoder"]["weight"]) + tied


def constrain_decoder_unit_norm(params: Params) -> Params:
    """Decoder columns (axis -2) back to unit norm, norms floored at 1e-12."""
    w = params["decoder"]["weight"]
    norms = torch.linalg.vector_norm(w, dim=-2, keepdim=True)
    return {**params, "decoder": {"weight": w / torch.clamp(norms, min=1e-12)}}


def remove_parallel_gradient(params: Params, grads: Params) -> Params:
    """Remove from each decoder column's gradient its component along that
    column (the reference's decoder weight hook)."""
    w = params["decoder"]["weight"]
    g = grads["decoder"]["weight"]
    dot = torch.sum(g * w, dim=-2, keepdim=True)
    norm_sq = torch.clamp(torch.sum(w * w, dim=-2, keepdim=True), min=1e-12)
    return {**grads, "decoder": {"weight": g - dot / norm_sq * w}}


# ---------------------------------------------------------------------------
# bridges: JAX pytrees and the reference torch state dict


def sae_params_from_numpy(params_np: Mapping, device: Union[str, torch.device] = "cpu") -> Params:
    """JAX's parameter pytree (as numpy arrays or anything ``np.asarray``
    takes) -> the port's fp32 tensors on ``device``."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=device), params_np)


def sae_params_to_numpy(params: Params) -> Dict:
    """The port's parameters -> a pytree of fp32 numpy arrays (JAX's layout)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def sae_state_dict_to_params(sd: Mapping, device: Union[str, torch.device] = "cpu") -> Params:
    """A reference SAE state dict (private ``_weight`` or public ``weight``
    keys; tensors or arrays) -> params."""

    def get(*names):
        for n in names:
            if n in sd:
                v = sd[n]
                v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
                return torch.tensor(np.asarray(v, np.float32), device=device)
        raise KeyError(names)

    return {
        "tied_bias": get("tied_bias"),
        "encoder": {"weight": get("encoder._weight", "encoder.weight"),
                    "bias": get("encoder._bias", "encoder.bias")},
        "decoder": {"weight": get("decoder._weight", "decoder.weight")},
    }


def sae_params_to_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """params -> the reference state dict (CPU tensors), as the JAX package
    writes it."""
    return {
        "tied_bias": params["tied_bias"].detach().cpu().clone(),
        "encoder._weight": params["encoder"]["weight"].detach().cpu().clone(),
        "encoder._bias": params["encoder"]["bias"].detach().cpu().clone(),
        "decoder._weight": params["decoder"]["weight"].detach().cpu().clone(),
    }
