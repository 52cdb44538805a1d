"""Adam with per-neuron moment reset (the AdamWithReset equivalent).

Counterpart of ``xclip_tpu/sae/optim.py`` (``optax.adam`` and
``reset_neuron_moments``), on tensors, in optax's order of operations:

    count += 1
    mu = (1 - b1) * g + b1 * mu
    nu = (1 - b2) * g**2 + b2 * nu
    mu_hat = mu / (1 - b1**count)     (the correction computed in fp32)
    nu_hat = nu / (1 - b2**count)
    p = p + (-lr) * (mu_hat / (sqrt(nu_hat) + eps))

``torch.optim.Adam`` puts eps and the bias corrections elsewhere, so the
port keeps its own. The moments are params-shaped dicts, updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from xclip_tpu_torch.sae.model import Params, tree_map


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params))

    def update(self, grads: Params, state: AdamState, params: Params) -> Params:
        """Advance ``state`` in place; return the new parameters."""
        state.count += 1
        # 1 - decay**count in fp32, as optax computes it
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(state.count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(state.count))

        def step(p, g, mu, nu):
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            return p + -self.learning_rate * ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps))

        return _map4(step, params, grads, state.mu, state.nu)


def _map4(fn, params, grads, mu, nu) -> Dict:
    return {k: _map4(fn, v, grads[k], mu[k], nu[k]) if isinstance(v, dict) else fn(v, grads[k], mu[k], nu[k])
            for k, v in params.items()}


def adam(learning_rate: float = 1e-4, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Adam:
    return Adam(learning_rate, b1, b2, eps)


def reset_neuron_moments(state: AdamState, dead_indices: np.ndarray, *, has_components: bool = False) -> AdamState:
    """Zero mu and nu of the resampled neurons, in place: encoder weight and
    bias along the learned-feature axis 0, decoder weight along axis 1 (one
    further right with a components axis, for every component, as JAX does)."""
    if len(dead_indices) == 0:
        return state
    off = 1 if has_components else 0
    dead = torch.as_tensor(np.asarray(dead_indices), dtype=torch.long, device=state.mu["tied_bias"].device)
    for moments in (state.mu, state.nu):
        for t, axis in ((moments["encoder"]["weight"], off), (moments["encoder"]["bias"], off),
                        (moments["decoder"]["weight"], 1 + off)):
            t.index_fill_(axis, dead, 0.0)
    return state
