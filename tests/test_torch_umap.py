"""The port's UMAP / densMAP (``xclip_tpu_torch.evals.umap``) and its
``embedding_analysis`` script against the JAX package's, on the CPU.

- the kNN: distances within 1e-5 relative, indices equal wherever the gap
  to the next distance exceeds fp32 rounding (``torch.topk`` and
  ``lax.top_k`` may order ties differently);
- ``smooth_knn_dist`` (equal on equal input), the fuzzy edge list element
  by element: the same edges in the same order, the weights within 2e-4
  (a weight magnifies its kNN distance's fp32 rounding by 1/sigma; 8.3e-5
  measured), and equal on equal kNN input; ``fit_ab`` and the spectral
  initialisation (equal on equal graphs);
- the layout: one epoch from JAX's initial layout with JAX's negatives
  (``jax.random.randint`` draws, injected) within 1e-4 (1.6e-5 measured).
  Longer runs are not comparable point by point: the clipped steps amplify
  fp32 rounding about tenfold an epoch (a 1e-5 difference after one epoch
  is O(1) after five), so the full runs are held by their quality instead:
  ``umap_embed`` with JAX's negatives at n = 300 and 200 epochs, plain and
  densMAP, within JAX's own spread over seeds 3-6 at this size (the share
  of kNN kept 0.016, silhouette 0.12, log-radius correlation 0.11): 0.03,
  0.12 and 0.12;
- the port's own sampler keeps ``tests/test_umap.py``'s properties
  (clusters preserved far better than PCA, densMAP's density ordering) and
  its layout is deterministic at a seed;
- ``embedding_analysis.json`` equals JAX's script's on the same features,
  the 2-D embedding injected into both.
"""

import argparse
import importlib.util
import json
import logging
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
from jax import lax

from test_torch_models import release_memory_after_module  # noqa: F401
from xclip_tpu.evals import umap as jax_umap
from xclip_tpu_torch.evals import umap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n_per, centers, dim, scales, seed=0):
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for i, (c, s) in enumerate(zip(centers, scales)):
        mu = np.zeros(dim)
        mu[: len(c)] = c
        xs.append(mu + s * rng.randn(n_per, dim))
        ys.append(np.full(n_per, i))
    return np.concatenate(xs).astype(np.float32), np.concatenate(ys)


@pytest.fixture(scope="module")
def data():
    """300 points in 16 dims: three clusters of different density."""
    return _blobs(100, [(0, 0), (10, 0), (0, 10)], 16, [1.0, 2.0, 0.5], seed=1)


@pytest.fixture(scope="module")
def graphs(data):
    x, _ = data
    return jax_umap.fuzzy_simplicial_set(x, K), umap.fuzzy_simplicial_set(x, K)


def _jax_negatives(seed, n_epochs, m, n):
    """The negatives JAX's layout draws: a key split per epoch, then
    ``randint(sub, (m,), 0, n)``."""
    def body(key, _):
        key, sub = jax.random.split(key)
        return key, jax.random.randint(sub, (m,), 0, n)

    return np.asarray(lax.scan(body, jax.random.PRNGKey(seed), None, length=n_epochs)[1])


def test_knn_matches_jax(data):
    x, _ = data
    want_d, want_i = jax_umap.exact_knn(x, K, block=64)
    got_d, got_i = umap.exact_knn(x, K, block=64)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    full = np.sort(np.linalg.norm(x[:, None].astype(np.float64) - x[None], axis=-1), axis=1)[:, 1:K + 2]
    clear = np.diff(full, axis=1)[:, :K] > 1e-4 * full[:, 1:K + 1]  # no tie within fp32 rounding
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
    assert got_i.dtype == np.int32 and (got_i != np.arange(len(x))[:, None]).all()


def test_smooth_knn_and_fuzzy_edges_match_jax(data, graphs):
    x, _ = data
    want, got = graphs
    rho, sigma = umap.smooth_knn_dist(want.knn_dists)
    want_rho, want_sigma = jax_umap.smooth_knn_dist(want.knn_dists)
    np.testing.assert_array_equal(rho, want_rho)
    np.testing.assert_array_equal(sigma, want_sigma)
    np.testing.assert_array_equal(got.head, want.head)  # the same edges in JAX's order
    np.testing.assert_array_equal(got.tail, want.tail)
    np.testing.assert_allclose(got.weight, want.weight, rtol=0, atol=2e-4)
    same = umap.fuzzy_graph_from_knn(want.knn_dists, want.knn_idx)
    for field in ("head", "tail", "weight"):
        np.testing.assert_array_equal(getattr(same, field), getattr(want, field))


def test_fit_ab_and_spectral_init_match_jax(data, graphs, caplog, monkeypatch):
    x, _ = data
    want, _ = graphs
    assert umap.fit_ab(0.1, 1.0) == jax_umap.fit_ab(0.1, 1.0)
    np.testing.assert_array_equal(umap.spectral_init(want, len(x), 2), jax_umap.spectral_init(want, len(x), 2))
    np.testing.assert_array_equal(umap.pca_init(x, 2), jax_umap.pca_init(x, 2))
    np.testing.assert_array_equal(umap.log_radius_orig(want), _jax_log_radius(want))

    import scipy.sparse.linalg as spla

    def no_convergence(*a, **k):
        raise spla.ArpackNoConvergence("no convergence", np.zeros(0), np.zeros((len(x), 0)))

    monkeypatch.setattr(spla, "eigsh", no_convergence)
    with caplog.at_level(logging.WARNING):
        assert umap.spectral_init(want, len(x), 2) is None
    assert any("spectral initialisation failed" in r.getMessage() for r in caplog.records)


def _jax_log_radius(graph):
    """JAX's densMAP original-space log radii, as ``umap_embed`` computes
    them inline."""
    rho = graph.knn_dists[:, 0]
    w_dir = np.exp(-np.maximum(graph.knn_dists - rho[:, None], 0.0)
                   / np.maximum(graph.knn_dists.mean(axis=1, keepdims=True), 1e-12))
    r = (w_dir * graph.knn_dists ** 2).sum(1) / np.maximum(w_dir.sum(1), 1e-12)
    return np.log(np.maximum(r, 1e-12)).astype(np.float32)


@pytest.mark.parametrize("densmap", [False, True], ids=["plain", "densmap"])
def test_layout_epochs_match_jax(data, graphs, densmap):
    x, _ = data
    want, _ = graphs
    a, b = jax_umap.fit_ab(0.1, 1.0)
    y0 = jax_umap.spectral_init(want, len(x), 2)
    log_r = _jax_log_radius(want)
    want_y = jax_umap._optimize_layout(
        y0, want.head, want.tail, want.weight, log_r, jax.random.PRNGKey(3), 1, 5, float(a), float(b), densmap, 2.0)
    negs = _jax_negatives(3, 1, 5 * len(want.head), len(x))
    got_y = umap.optimize_layout(y0, want, log_r, n_epochs=1, a=a, b=b, densmap=densmap, dens_lambda=2.0, seed=3,
                                 negatives=negs)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-4)
    assert np.abs(got_y.numpy() - y0).max() > 0.1  # the step moved the layout


def _silhouette(emb, labels):
    """Mean silhouette coefficient (scikit-learn's definition, in numpy)."""
    d = np.linalg.norm(emb[:, None].astype(np.float64) - emb[None], axis=-1)
    same = labels[:, None] == labels[None]
    a = (d * same).sum(1) / (same.sum(1) - 1)
    b = np.min([np.where(labels == c, np.inf, d[:, labels == c].mean(1)) for c in np.unique(labels)], axis=0)
    return float(np.mean((b - a) / np.maximum(a, b)))


def _quality(x, labels, emb):
    """(share of each point's K input-space neighbours among its K
    embedding neighbours, silhouette, correlation of the log mean kNN
    distances of the two spaces: the density signal densMAP keeps)."""
    dx, ix = umap.exact_knn(x, K)
    de, ie = umap.exact_knn(emb.astype(np.float32), K)
    kept = np.mean([len(set(a) & set(b)) / K for a, b in zip(ix, ie)])
    corr = np.corrcoef(np.log(dx.mean(1)), np.log(np.maximum(de.mean(1), 1e-12)))[0, 1]
    return kept, _silhouette(emb, labels), corr


@pytest.mark.parametrize("densmap", [False, True], ids=["plain", "densmap"])
def test_umap_embed_with_jax_negatives_matches_jax_in_quality(data, graphs, densmap):
    x, labels = data
    n_epochs = 200
    want = jax_umap.umap_embed(x, n_neighbors=K, n_epochs=n_epochs, seed=3, densmap=densmap)
    negs = _jax_negatives(3, n_epochs, 5 * len(graphs[0].head), len(x))
    got = umap.umap_embed(x, n_neighbors=K, n_epochs=n_epochs, seed=3, densmap=densmap, negatives=negs)
    assert got.shape == (300, 2) and got.dtype == np.float32 and np.isfinite(got).all()
    (gt, gs, gc), (wt, ws, wc) = _quality(x, labels, got), _quality(x, labels, want)
    assert abs(gt - wt) < 0.03 and abs(gs - ws) < 0.12 and abs(gc - wc) < 0.12, ((gt, gs, gc), (wt, ws, wc))
    if densmap:
        assert gc > 0.5


def test_own_sampler_keeps_quality_and_determinism():
    """``tests/test_umap.py``'s properties with the port's own negatives:
    four separated clusters (silhouette > 0.5, 0.1 more of the kNN kept
    than PCA keeps, far from any linear projection), two layouts at one
    seed equal bit for bit;
    densMAP on two clusters 6x apart in scale keeps the density ordering
    (log-radius correlation > 0.5 and 0.3 above plain UMAP's)."""
    x, labels = _blobs(60, [(0, 0), (12, 0), (0, 12), (12, 12)], 40, [1, 1, 1, 1])
    emb = umap.umap_embed(x, n_neighbors=K, n_epochs=200, seed=3)
    kept, silhouette, _ = _quality(x, labels, emb)
    assert silhouette > 0.5 and kept > _quality(x, labels, umap.pca_init(x, 2))[0] + 0.1
    coef, *_ = np.linalg.lstsq(x - x.mean(0), emb - emb.mean(0), rcond=None)
    assert np.abs(emb - emb.mean(0) - (x - x.mean(0)) @ coef).max() > 1e-3
    graph = umap.fuzzy_simplicial_set(x, K)
    y0 = umap.pca_init(x, 2)
    runs = [umap.optimize_layout(y0, graph, umap.log_radius_orig(graph), n_epochs=20, a=1.577, b=0.895,
                                 densmap=True, dens_lambda=2.0, seed=9) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])

    x, labels = _blobs(80, [(0, 0), (60, 0)], 20, [0.5, 3.0], seed=5)
    plain = umap.umap_embed(x, n_neighbors=K, n_epochs=200, seed=5)
    dens = umap.umap_embed(x, n_neighbors=K, n_epochs=200, seed=5, densmap=True)
    c_plain, c_dens = _quality(x, labels, plain)[2], _quality(x, labels, dens)[2]
    assert c_dens > 0.5 and c_dens > c_plain + 0.3


def test_embedding_analysis_json_matches_jax(tmp_path, monkeypatch, capsys):
    """Both scripts on the same (checkpoints, N, D) features, each given the
    same 2-D embedding: equal ``embedding_analysis.json`` bytes; the port's
    ``embedding.npy`` is the embedding of the subsample it drew, and it
    draws the figures where matplotlib imports."""
    from xclip_tpu_torch.scripts import embedding_analysis as port_script

    rng = np.random.RandomState(0)
    feats = tmp_path / "feats"
    feats.mkdir()
    np.save(feats / "img_feat.npy", rng.randn(2, 60, 16).astype(np.float32))
    np.save(feats / "domain_ids.npy", rng.randint(0, 6, 60))
    np.save(feats / "domain_labels.npy", rng.randint(0, 5, 60))
    fixed = {}

    def embed(f, seed=0, device=None):
        fixed.setdefault(len(f), rng.randn(len(f), 2).astype(np.float32))
        return fixed[len(f)]

    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    spec = importlib.util.spec_from_file_location("jax_emban", os.path.join(REPO, "scripts", "embedding_analysis.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    monkeypatch.setattr(jax_script, "embed_2d", embed)
    plt = mock.MagicMock()  # JAX's figures are not under test
    plt.subplots.side_effect = lambda *a, **k: (mock.MagicMock(), mock.MagicMock())
    monkeypatch.setattr(jax_script, "plt", plt)
    monkeypatch.setattr(port_script, "embed_2d", embed)
    jax_script.main(argparse.Namespace(features_path=str(feats), out_path=str(tmp_path / "jax"), max_points=50))
    want_out = capsys.readouterr().out
    assert port_script.main(["--features_path", str(feats), "--out_path", str(tmp_path / "port"),
                             "--max_points", "50", "--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    assert got_out.splitlines()[-1] == want_out.splitlines()[-1]
    assert "figures: embedding.png, domain_distances.png, quickdraw_separation.png" in got_out
    got = (tmp_path / "port" / "embedding_analysis.json").read_bytes()
    assert got == (tmp_path / "jax" / "embedding_analysis.json").read_bytes()
    assert set(json.loads(got)) == {"domain_distance_matrix", "quickdraw_top_dims", "quickdraw_max_absdiff"}
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "embedding.npy"), fixed[50])
    for png in ("embedding.png", "domain_distances.png", "quickdraw_separation.png"):
        assert (tmp_path / "port" / png).stat().st_size > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert port_script.main(["--features_path", str(feats), "--out_path", str(tmp_path / "bare"),
                             "--max_points", "0", "--device", "cpu"]) == 0
    assert "figures: none" in capsys.readouterr().out
    assert not list((tmp_path / "bare").glob("*.png")) and np.load(tmp_path / "bare" / "embedding.npy").shape == (60, 2)
