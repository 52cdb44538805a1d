"""Centered Kernel Alignment (CKA) representational similarity.

Counterpart of ``xclip_tpu/interp/cka.py`` (the reference's
``representational_analysis.py:150-228``): linear and RBF-kernel CKA with
the unbiased HSIC1 estimator (Song et al. 2012) on class-mean activations,
in float64 as the reference computes it (JAX computes in fp32 unless x64
is enabled). Inputs (numpy arrays or tensors) are taken to float64 on
their own device, the CPU for numpy.

The RBF bandwidth is the median of the squared distances, averaged over
the two middle values when their count is even, as ``np.median`` and
``jnp.median`` take it (``torch.median`` returns the lower one).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _f64(x) -> torch.Tensor:
    return x.to(torch.float64) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), dtype=torch.float64)


def median(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the two middle values averaged for an even count."""
    v = x.flatten().sort().values
    m = v.numel()
    return v[m // 2] if m % 2 else (v[m // 2 - 1] + v[m // 2]) / 2


def rbf_kernel(x: torch.Tensor, sigma: Optional[float] = None) -> torch.Tensor:
    """RBF gram matrix with the reference's median-distance bandwidth
    heuristic (representational_analysis.py:160-173)."""
    gram = x @ x.T
    sq_norms = torch.diagonal(gram)
    dists = sq_norms[:, None] - 2 * gram + sq_norms[None, :]
    if sigma is None:
        sigma_sq = median(dists)
        sigma_sq = torch.where(sigma_sq <= 0, torch.ones_like(sigma_sq), sigma_sq)
    else:
        sigma_sq = sigma ** 2
    return torch.exp(-0.5 * dists / sigma_sq)


def hsic0(k: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Biased HSIC estimator."""
    n = k.shape[0]
    h = torch.eye(n, dtype=k.dtype, device=k.device) - torch.ones((n, n), dtype=k.dtype, device=k.device) / n
    return torch.trace(k @ h @ l @ h) / (n - 1) ** 2


def hsic1(k: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Unbiased HSIC1 estimator (Song et al. 2012; reference :184-199)."""
    n = k.shape[0]
    k_t = k - torch.diag(torch.diagonal(k))
    l_t = l - torch.diag(torch.diagonal(l))
    kl = k_t @ l_t
    trace_term = torch.trace(kl)
    constant_term = torch.sum(k_t) * torch.sum(l_t) / ((n - 1) * (n - 2))
    cross_term = 2.0 / (n - 2) * torch.sum(kl)
    return (trace_term + constant_term - cross_term) / (n * (n - 3))


def cka_from_grams(k: torch.Tensor, l: torch.Tensor, hsic=hsic1) -> torch.Tensor:
    return hsic(k, l) / torch.sqrt(hsic(k, k) * hsic(l, l))


def linear_cka(x, y, hsic=hsic1) -> float:
    x, y = _f64(x), _f64(y)
    return float(cka_from_grams(x @ x.T, y @ y.T, hsic))


def kernel_cka(x, y, hsic=hsic1, sigma: Optional[float] = None) -> float:
    x, y = _f64(x), _f64(y)
    return float(cka_from_grams(rbf_kernel(x, sigma), rbf_kernel(y, sigma), hsic))


def class_mean_activations(acts: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Mean activation per class (the reference evaluates CKA on class means,
    :337-412). Returns (n_present_classes, features)."""
    classes = np.unique(labels)
    return np.stack([acts[labels == c].mean(axis=0) for c in classes])
