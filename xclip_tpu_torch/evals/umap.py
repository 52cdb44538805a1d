"""UMAP / densMAP 2-D embedding for the embedding analysis (paper Fig. 5).

A port of ``xclip_tpu/evals/umap.py``, JAX's own implementation of UMAP
(McInnes et al., arXiv:1802.03426) with the densMAP density term (Narayan
et al., Nat. Biotechnol. 2021); umap-learn is not used. The kNN search and
the layout run on the device of the tensor given; the graph (smoothed kNN
kernel, fuzzy union, the (a, b) fit, the spectral initialisation) is built
on the host with numpy and scipy, as in JAX:

- :func:`exact_knn`: blocks of 512 rows, ``d2 = |r|^2 - 2 r.x^T + |x|^2``
  in fp32 without TF32, self excluded by index, ``torch.topk``;
- :func:`fuzzy_simplicial_set`: JAX's dict-built symmetric edge list, in
  JAX's edge order (the repulsive negatives pair with ``tile(head, 5)`` by
  position);
- :func:`optimize_layout`: full-batch SGD on the fuzzy cross-entropy plus
  the densMAP Pearson penalty (``0.15 * E * dens_lambda``), the gradient
  from ``torch.autograd``, each step clipped to +-4 and scaled by
  ``1 - epoch / n_epochs``. The negatives come from a ``torch.Generator``
  on the layout's device seeded with ``seed``, or from the caller
  (``negatives[epoch]``). The loop runs under
  ``torch.use_deterministic_algorithms(True)``, so its scatter-adds
  (``index_put_`` with ``accumulate=True``, and each gather's backward) sum
  in a fixed order and a run is bit for bit the same at a seed.

A spectral initialisation that fails (ARPACK without convergence, or any
other error) is logged and replaced by PCA, as JAX replaces it silently.
"""

from __future__ import annotations

import contextlib
import logging
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


class FuzzyGraph(NamedTuple):
    head: np.ndarray  # (E,) int32 edge sources
    tail: np.ndarray  # (E,) int32 edge targets
    weight: np.ndarray  # (E,) float32 membership strengths in (0, 1]
    knn_dists: np.ndarray  # (N, k) float32 original-space kNN distances
    knn_idx: np.ndarray  # (N, k) int32 kNN indices


def _as_tensor(x: Array) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)) if isinstance(x, np.ndarray) else x.float()


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block: the
    layout's scatter-adds (``index_put_`` with ``accumulate=True``, and a
    gather's backward) then sum in a fixed order on the CPU's threads and on
    the card."""
    saved = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# kNN: blocked pairwise distances, exact top-k.


def knn_device(x: torch.Tensor, k: int, block: int = 512):
    """Exact k-nearest neighbours of the rows of ``x`` (Euclidean, self
    excluded) on ``x``'s device: (distances, indices), each (N, k)."""
    n = x.shape[0]
    sq = (x * x).sum(dim=1)
    dists, idx = [], []
    with _no_tf32():
        for start in range(0, n, block):
            rows, rsq = x[start:start + block], sq[start:start + block]
            d2 = rsq[:, None] - 2.0 * (rows @ x.T) + sq[None, :]
            own = torch.arange(start, start + rows.shape[0], device=x.device)
            d2[torch.arange(rows.shape[0], device=x.device), own] = torch.inf
            val, nb = torch.topk(d2, k, dim=1, largest=False)
            dists.append(torch.sqrt(torch.clamp_min(val, 0.0)))
            idx.append(nb)
    return torch.cat(dists), torch.cat(idx)


def exact_knn(x: Array, k: int, block: int = 512):
    """Exact k-nearest neighbours (Euclidean), self excluded, as numpy
    (float32 distances, int32 indices)."""
    d, i = knn_device(_as_tensor(x), k, min(block, x.shape[0]))
    return d.cpu().numpy(), i.cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Smoothed kNN kernel -> fuzzy simplicial set (paper Algorithms 2-3).

_SMOOTH_TOL = 1e-5
_MIN_K_DIST_SCALE = 1e-3


def smooth_knn_dist(knn_dists: np.ndarray, n_iter: int = 64):
    """Per-point (rho, sigma): rho = distance to the nearest neighbour, sigma
    solves sum_j exp(-max(d_ij - rho, 0) / sigma) = log2(k) by binary search
    (vectorized over points)."""
    k = knn_dists.shape[1]
    target = np.log2(k)
    rho = knn_dists[:, 0].copy()
    pos = knn_dists[knn_dists > 0.0]
    mean_all = float(pos.mean()) if pos.size else 1.0  # all-identical input: rho 0, sigma 1

    lo = np.zeros(len(knn_dists))
    hi = np.full(len(knn_dists), np.inf)
    mid = np.ones(len(knn_dists))
    adj = np.maximum(knn_dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        val = np.exp(-adj / mid[:, None]).sum(axis=1)
        done = np.abs(val - target) < _SMOOTH_TOL
        too_big = val > target
        hi = np.where(too_big & ~done, mid, hi)
        lo = np.where(~too_big & ~done, mid, lo)
        mid = np.where(done, mid, np.where(np.isinf(hi), mid * 2.0, (lo + hi) / 2.0))
    # umap-learn's floor: sigma >= 1e-3 * mean distance (local, else global)
    mean_i = knn_dists.mean(axis=1)
    floor = np.where(mean_i > 0, _MIN_K_DIST_SCALE * mean_i, _MIN_K_DIST_SCALE * mean_all)
    return rho, np.maximum(mid, floor)


def fuzzy_graph_from_knn(knn_dists: np.ndarray, knn_idx: np.ndarray) -> FuzzyGraph:
    """Directed memberships symmetrized with the probabilistic t-conorm
    ``P = A + A^T - A o A^T`` (paper section 3.1), as an edge list in the
    insertion order of JAX's dicts."""
    n, n_neighbors = knn_idx.shape
    rho, sigma = smooth_knn_dist(knn_dists)
    w = np.exp(-np.maximum(knn_dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n, dtype=np.int64), n_neighbors)
    cols = knn_idx.reshape(-1).astype(np.int64)
    vals = w.reshape(-1).astype(np.float64)

    direct = {}
    for r, c, v in zip(rows, cols, vals):
        direct[(r, c)] = v
    sym = {}
    for (r, c), v in direct.items():
        vt = direct.get((c, r), 0.0)
        if (c, r) in sym:
            continue
        s = v + vt - v * vt
        if s > 0.0:
            sym[(r, c)] = s
            sym[(c, r)] = s
    head = np.fromiter((e[0] for e in sym), np.int32, len(sym))
    tail = np.fromiter((e[1] for e in sym), np.int32, len(sym))
    weight = np.fromiter(sym.values(), np.float32, len(sym))
    return FuzzyGraph(head, tail, weight, knn_dists.astype(np.float32), knn_idx.astype(np.int32))


def fuzzy_simplicial_set(x: Array, n_neighbors: int) -> FuzzyGraph:
    """The fuzzy graph of ``x``'s ``n_neighbors`` nearest neighbours (kNN on
    ``x``'s device)."""
    return fuzzy_graph_from_knn(*exact_knn(x, n_neighbors))


# ---------------------------------------------------------------------------
# (a, b) from (min_dist, spread): least-squares fit of 1/(1 + a d^{2b}) to the
# piecewise target curve (min_dist 0.1, spread 1 -> a = 1.577, b = 0.895).


def fit_ab(min_dist: float, spread: float):
    from scipy.optimize import curve_fit

    xs = np.linspace(0.0, 3.0 * spread, 300)
    ys = np.where(xs <= min_dist, 1.0, np.exp(-(xs - min_dist) / spread))
    (a, b), _ = curve_fit(lambda d, a, b: 1.0 / (1.0 + a * d ** (2.0 * b)), xs, ys, p0=(1.0, 1.0), maxfev=10000)
    return float(a), float(b)


# ---------------------------------------------------------------------------
# Initialization: spectral layout of the symmetric normalized Laplacian
# (paper section 3.3); PCA when it fails.


def spectral_init(graph: FuzzyGraph, n: int, n_components: int) -> Optional[np.ndarray]:
    """The Laplacian's eigenvectors 1..n_components (ARPACK, ``which="SM"``,
    ``v0 = ones`` for determinism) scaled to the +-10 box; None, logged,
    when it fails."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        adj = sp.coo_matrix((graph.weight.astype(np.float64), (graph.head, graph.tail)), shape=(n, n)).tocsr()
        deg = np.asarray(adj.sum(axis=1)).ravel()
        dinv = sp.diags(1.0 / np.sqrt(np.maximum(deg, 1e-12)))
        lap = sp.identity(n) - dinv @ adj @ dinv
        k = n_components + 1
        vals, vecs = spla.eigsh(lap, k=k, which="SM", tol=1e-4, maxiter=n * 20, v0=np.ones(n))
        order = np.argsort(vals)[1:k]
        emb = vecs[:, order]
        emb = 10.0 * emb / np.abs(emb).max()
        return emb.astype(np.float32)
    except Exception as exc:  # JAX's semantics: any failure falls back to PCA
        logging.warning(f"umap: spectral initialisation failed ({exc!r}); using PCA")
        return None


def pca_init(x: np.ndarray, n_components: int) -> np.ndarray:
    c = x - x.mean(axis=0)
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    emb = c @ vt[:n_components].T
    return (10.0 * emb / np.abs(emb).max()).astype(np.float32)


def log_radius_orig(graph: FuzzyGraph) -> np.ndarray:
    """densMAP's original-space log local radii from the kNN kernel."""
    rho = graph.knn_dists[:, 0]
    w_dir = np.exp(-np.maximum(graph.knn_dists - rho[:, None], 0.0)
                   / np.maximum(graph.knn_dists.mean(axis=1, keepdims=True), 1e-12))
    r_orig = (w_dir * graph.knn_dists ** 2).sum(1) / np.maximum(w_dir.sum(1), 1e-12)
    return np.log(np.maximum(r_orig, 1e-12)).astype(np.float32)


# ---------------------------------------------------------------------------
# Layout optimization.


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_put((seg,), vals, accumulate=True)


def _pearson(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    uc, vc = u - u.mean(), v - v.mean()
    return (uc * vc).sum() / torch.clamp_min(torch.sqrt((uc * uc).sum() * (vc * vc).sum()), 1e-12)


def layout_loss(y, head, tail, weight, neg_head, neg_tail, log_r_orig, a: float, b: float, densmap: bool,
                dens_lambda: float) -> torch.Tensor:
    """UMAP's fuzzy cross-entropy over the edges and the sampled non-edges,
    less ``dens_lambda * 0.15 * E`` times the Pearson correlation of the
    log local radii with densMAP."""
    n = y.shape[0]
    diff2 = ((y[head] - y[tail]) ** 2).sum(dim=1)
    d2 = torch.clamp_min(diff2, 1e-10)  # keeps d2**(b-1) finite at coincident points
    attract = weight * torch.log1p(a * d2 ** b)
    nd2 = ((y[neg_head] - y[neg_tail]) ** 2).sum(dim=1)
    q_neg = 1.0 / (1.0 + a * torch.clamp_min(nd2, 1e-3) ** b)
    repulse = -torch.log1p(-torch.clamp_max(q_neg, 1.0 - 1e-4))
    loss = attract.sum() + repulse.sum()
    if densmap:
        r_emb = _segment_sum(weight * diff2, head, n) / torch.clamp_min(_segment_sum(weight, head, n), 1e-12)
        corr = _pearson(torch.log(torch.clamp_min(r_emb, 1e-12)), log_r_orig)
        loss = loss - dens_lambda * 0.15 * head.shape[0] * corr
    return loss


def optimize_layout(y0: Array, graph: FuzzyGraph, log_r_orig: Array, *, n_epochs: int, a: float, b: float,
                    densmap: bool, dens_lambda: float, seed: int, neg_rate: int = 5,
                    device: Union[str, torch.device] = "cpu",
                    negatives: Optional[Sequence[Array]] = None) -> torch.Tensor:
    """``n_epochs`` clipped full-batch gradient steps from ``y0`` on
    ``device``; returns the layout there. ``negatives[epoch]``, when given,
    holds that epoch's ``E * neg_rate`` repulsive tail indices."""
    device = torch.device(device)
    y = torch.as_tensor(np.asarray(y0, np.float32)).to(device)
    head = torch.as_tensor(graph.head, dtype=torch.long, device=device)
    tail = torch.as_tensor(graph.tail, dtype=torch.long, device=device)
    weight = torch.as_tensor(graph.weight, device=device)
    log_r = torch.as_tensor(np.asarray(log_r_orig, np.float32), device=device)
    neg_head = head.repeat(neg_rate)
    n, n_neg = y.shape[0], head.shape[0] * neg_rate
    gen = torch.Generator(device=device).manual_seed(seed)
    with _deterministic():
        for epoch in range(n_epochs):
            if negatives is None:
                neg_tail = torch.randint(0, n, (n_neg,), generator=gen, device=device)
            else:
                neg_tail = torch.as_tensor(np.array(negatives[epoch], dtype=np.int64), device=device)
            y.requires_grad_(True)
            loss = layout_loss(y, head, tail, weight, neg_head, neg_tail, log_r, a, b, densmap, dens_lambda)
            (g,) = torch.autograd.grad(loss, y)
            # alpha in fp32 as JAX computes it: 1 - float32(epoch) / float32(n_epochs)
            alpha = float(np.float32(1.0) - np.float32(epoch) / np.float32(n_epochs))
            with torch.no_grad():
                y = y.detach() - alpha * torch.clamp(g, -4.0, 4.0)
    return y.detach()


def umap_embed(x: Array, n_components: int = 2, n_neighbors: int = 15, min_dist: float = 0.1,
               spread: float = 1.0, n_epochs: Optional[int] = None, densmap: bool = False,
               dens_lambda: float = 2.0, seed: int = 0, init: str = "spectral",
               negatives: Optional[Sequence[Array]] = None) -> np.ndarray:
    """UMAP embedding of ``x`` (N, D) -> (N, n_components) as numpy, the kNN
    and the layout on ``x``'s device (numpy: the CPU). ``densmap=True`` adds
    the densMAP penalty (the reference's ``umap.UMAP(densmap=True)``). 500
    epochs below 10,000 points, 200 from there, unless ``n_epochs`` says."""
    xt = _as_tensor(x)
    n = xt.shape[0]
    if n <= n_neighbors:
        n_neighbors = max(2, n - 1)
    graph = fuzzy_simplicial_set(xt, n_neighbors)
    a, b = fit_ab(min_dist, spread)
    if n_epochs is None:
        n_epochs = 500 if n < 10000 else 200
    y0 = spectral_init(graph, n, n_components) if init == "spectral" else None
    if y0 is None:
        y0 = pca_init(xt.cpu().numpy(), n_components)
    # tiny seeded jitter breaks spectral ties (umap-learn does the same)
    y0 = y0 + np.random.RandomState(seed).normal(0, 1e-4, y0.shape).astype(np.float32)
    y = optimize_layout(y0, graph, log_radius_orig(graph), n_epochs=int(n_epochs), a=a, b=b, densmap=densmap,
                        dens_lambda=dens_lambda, seed=seed, device=xt.device, negatives=negatives)
    return y.cpu().numpy()
