"""Dictionaries for circuit analysis: identity (neuron basis) and SAE basis.

Counterpart of ``xclip_tpu/interp/dictionary.py`` (the reference's
``dictionary.py:7-54``): an encode/decode interface; ``IdentityDict`` is the
identity "SAE" of neuron-level circuits (compute_circuits.py uses one for
each of the 22 submodules), ``SAEDictionary`` exposes a trained sparse
autoencoder (the port's ``sae.model`` parameters) in the same interface for
feature-level circuits.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from xclip_tpu_torch.sae.model import sae_apply, sae_state_dict_to_params


class Dictionary:
    activation_dim: int
    dict_size: int

    def encode(self, x):
        raise NotImplementedError

    def decode(self, f):
        raise NotImplementedError

    def forward_for_sfc(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x_hat, f) pair (the reference's hacked_forward_for_sfc)."""
        f = self.encode(x)
        return self.decode(f), f


class IdentityDict(Dictionary):
    """encode = decode = identity (reference dictionary.py:30-54)."""

    def __init__(self, activation_dim: int):
        self.activation_dim = activation_dim
        self.dict_size = activation_dim

    def encode(self, x):
        return x

    def decode(self, f):
        return f


class SAEDictionary(Dictionary):
    """Trained SAE parameters (``sae.model`` layout, no components axis)."""

    def __init__(self, params: Dict):
        self.params = params
        w = params["encoder"]["weight"]
        self.dict_size = w.shape[-2]
        self.activation_dim = w.shape[-1]

    def encode(self, x):
        centered = x - self.params["tied_bias"]
        return torch.relu(centered @ self.params["encoder"]["weight"].t() + self.params["encoder"]["bias"])

    def decode(self, f):
        return f @ self.params["decoder"]["weight"].t() + self.params["tied_bias"]

    def forward_for_sfc(self, x):
        learned, decoded = sae_apply(self.params, x)
        return decoded, learned


def load_sae_dictionary(path: str, device: Union[str, torch.device] = "cpu") -> SAEDictionary:
    """Load a trained SAE checkpoint (a ``.pt`` state dict, or the ``.npz``
    of the same keys) as a circuit dictionary on ``device``. A leading
    single-component axis (1, ...) is squeezed."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = {k: z[k] for k in z.files}
    else:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    params = sae_state_dict_to_params(sd, device=device)
    for holder, key in ((params, "tied_bias"), (params["encoder"], "weight"),
                        (params["encoder"], "bias"), (params["decoder"], "weight")):
        v = holder[key]
        if v.dim() > (2 if key == "weight" else 1) and v.shape[0] == 1:
            holder[key] = v[0]
    return SAEDictionary(params)


def resolve_sae_checkpoint(sae_dir: str, submodule: str) -> Optional[str]:
    """The checkpoint for ``submodule`` under ``sae_dir``: a flat
    ``{submodule}.pt``/``.npz`` or the training pipeline's nested
    ``{submodule}/checkpoints/sparse_autoencoder_final.{pt,npz}``."""
    candidates = [
        os.path.join(sae_dir, f"{submodule}.pt"),
        os.path.join(sae_dir, f"{submodule}.npz"),
        os.path.join(sae_dir, submodule, "checkpoints", "sparse_autoencoder_final.pt"),
        os.path.join(sae_dir, submodule, "checkpoints", "sparse_autoencoder_final.npz"),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None
