"""The port's interpretability slice against ``xclip_tpu.interp`` on the CPU.

A tiny RN CLIP (``tests/test_interp.py``'s ``TINY_RN``) is initialised by
JAX from a seed, its BatchNorms set to seeded random values (bn3's zero
init would hide conv1 and conv3 from every gradient), and bridged into the
port with ``core.checkpoint.state_dict_from_jax_params``; images, patches
and text heads are numpy arrays from a seed, handed to both packages.
Everything is fp32 and differs by summation order only. Tolerances:

- stage activations, ``run_from`` and ``run_segment``: atol 1e-5;
- IG node effects, grads, deltas and edge effects: rtol 1e-4, atol 1e-6,
  and within 2e-3 of each array's largest |value| (effects at single
  positions lie far below atol; the patched attnpool deltas, differences
  of two forward passes' outputs, measure 1.1e-3, everything else below
  2e-6), for all copies in one pass and for one copy a pass (the port
  stacks IG points and neuron copies along the batch axis; JAX scans and
  vmaps);
- the class-circuit files: the same keys, values at rtol 1e-4 / atol 1e-6;
  the selected channels equal wherever the ``|effect|`` gaps at and above
  the cut exceed 1e-4 of the largest effect, edge effects compared on the
  (downstream, upstream) channels both selections hold;
- the graph functions against JAX's networkx versions: node and edge
  lists in order, attributes exact, Jaccard exact, WL within 1e-12, the
  DOT source byte for byte;
- HSIC and CKA in float64 against JAX with x64 enabled: rtol 1e-12;
- feature-sharing histograms and JSON, decoded SAE configs and concept
  names: exact; vocabulary embeddings atol 1e-5.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_models import _randomize_bn, release_memory_after_module  # noqa: F401
from xclip_tpu.interp import attribution as jax_attr
from xclip_tpu.interp import circuits as jax_circuits
from xclip_tpu.interp import cka as jax_cka
from xclip_tpu.interp import dictionary as jax_dict
from xclip_tpu.interp import feature_sharing as jax_fs
from xclip_tpu.interp import graph as jax_graph
from xclip_tpu.interp.circuit_model import VisualCircuitModel as JaxCircuitModel
from xclip_tpu.models import resnet as R
from xclip_tpu.models.clip import CLIPModel
from xclip_tpu.models.clip import clip_cfg_from_dict as jax_clip_cfg_from_dict
from xclip_tpu.sae import model as jax_sae
from xclip_tpu.sae import naming as jax_naming
from xclip_tpu.tokenizer import tokenize as jax_tokenize
from xclip_tpu_torch.core.checkpoint import bottleneck_state_dict, state_dict_from_jax_params
from xclip_tpu_torch.interp import attribution, circuits, cka, dictionary, feature_sharing, graph
from xclip_tpu_torch.interp.circuit_model import VisualCircuitModel
from xclip_tpu_torch.interp.sparse_act import SparseAct
from xclip_tpu_torch.models.clip import CLIP, clip_cfg_from_dict
from xclip_tpu_torch.models.resnet import Bottleneck, resnet_stage_names
from xclip_tpu_torch.ops import fused_conv
from xclip_tpu_torch.sae import model as sae_model
from xclip_tpu_torch.sae import naming
from xclip_tpu_torch.tokenizer import SimpleTokenizer

TINY_RN = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "layers": [1, 1, 1, 1], "width": 8, "patch_size": None},
    "text_cfg": {"context_length": 16, "vocab_size": 256, "width": 16, "heads": 2, "layers": 1},
}
RTOL, ATOL = 1e-4, 1e-6
SCALE_TOL = 2e-3
STEPS = 3
LABEL = 3
THRESHOLD = 0.25
# node effects in detail (effects, grads, deltas) at these submodules;
# every submodule's aggregated effect is in the class-circuit files
SUBMODULES = {"none": ["input", "avgpool", "resblock2", "attnpool"], "patch": ["resblock1", "attnpool"]}
# adjacent pairs through a stem conv, the pool, a bottleneck with a
# downsample, a stride-2 bottleneck and attnpool
PAIRS = [("input", "act1"), ("act3", "avgpool"), ("avgpool", "resblock1"), ("resblock2", "resblock3"),
         ("resblock4", "attnpool")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, n=2):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """(JAX circuit model, port circuit model, JAX CLIP, params) on one
    seeded tiny RN with random BatchNorms and one random text head."""
    jmodel = CLIPModel(jax_clip_cfg_from_dict(TINY_RN))
    params, state = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    _randomize_bn(params["visual"], state["visual"], np.random.RandomState(1))
    txt = np.random.RandomState(0).randn(7, 16).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    cfg = clip_cfg_from_dict(TINY_RN)
    with torch.device("meta"):
        port = CLIP(cfg)
    port = port.to_empty(device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params, state, cfg), strict=True)
    jcm = JaxCircuitModel(jmodel, params, state, txt)
    # one compile for the clean pass that every JAX effect starts from (the
    # eager one compiles each op, ~8 s here), in the eager pass's stage order
    clean = jax.jit(jcm.activations)
    jcm.activations = lambda images: (lambda a: {s.name: a[s.name] for s in jcm.stages})(clean(images))
    return jcm, VisualCircuitModel(port, txt), jmodel, params


MAX_SCALED_ERR = []  # (what, max |got - want| / max |want|) of every IG comparison


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    """Elementwise within rtol and atol; with rtol, also within SCALE_TOL of
    the array's largest |value| (IG effects of single positions can lie
    below atol)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    if rtol and want.size and np.abs(want).max() > 0:
        err = float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
        MAX_SCALED_ERR.append((what, err))
        assert err <= SCALE_TOL, (what, err)


# --- the stage-addressable tower and the circuit model ----------------------


def test_stages_and_activations_match_jax(models):
    jcm, pcm, _, _ = models
    assert [(s.name, s.index, s.spatial, s.channels) for s in pcm.stages] == \
           [(s.name, s.index, s.spatial, s.channels) for s in jcm.stages]
    assert resnet_stage_names(pcm.cfg) == R.resnet_stage_names(jcm.cfg)
    x = _images(0)
    want = jcm.activations(jnp.asarray(x))
    got = pcm.activations(x)
    assert list(got) == list(want) and len(got) == 10
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        _close(got[name], want[name], rtol=0, atol=1e-5, what=name)


def test_run_from_and_run_segment_match_jax(models):
    jcm, pcm, _, _ = models
    acts = jcm.activations(jnp.asarray(_images(0)))
    pairs = list(zip(jcm.stages[:-1], jcm.stages[1:]))
    # JAX's every run_from and run_segment in one compile
    want = jax.jit(lambda a: ([jcm.run_from(s.name, a[s.name]) for s in jcm.stages],
                              [jcm.run_segment(u.name, d.name, a[u.name]) for u, d in pairs]))(acts)
    for s, w in zip(jcm.stages, want[0]):
        _close(pcm.run_from(s.name, torch.from_numpy(np.array(acts[s.name]))), w, rtol=0, atol=1e-5, what=s.name)
    for (up, down), w in zip(pairs, want[1]):
        _close(pcm.run_segment(up.name, down.name, torch.from_numpy(np.array(acts[up.name]))), w,
               rtol=0, atol=1e-5, what=up.name)


def test_eval_bottleneck_backward_runs_the_function_and_matches_jax():
    """Grad enabled, the eval-mode bottleneck goes through MatmulAffineAct
    (conv1, the downsample, conv3): its backward runs, and the input
    gradient matches jax.grad of JAX's eval bottleneck; under no_grad the
    same route records no graph and runs no backward."""
    rng = np.random.RandomState(3)
    p, s = jax.device_get(R._bottleneck_init(jax.random.PRNGKey(3), 16, 8, 2))
    _randomize_bn(p, s, rng)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    block = Bottleneck(16, 8, 2)
    block.load_state_dict(bottleneck_state_dict(p, s), strict=True)
    block.eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    before = fused_conv.affine_act_backward_calls
    out = block(xt)
    out.square().sum().backward()
    assert fused_conv.affine_act_backward_calls == before + 3
    want = jax.jit(jax.grad(lambda v: jnp.sum(R._bottleneck_apply(p, s, v, stride=2, train=False,
                                                                  dtype=None)[0] ** 2)))(jnp.asarray(x))
    _close(xt.grad.permute(0, 2, 3, 1), want, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        assert block(xt).grad_fn is None
    assert fused_conv.affine_act_backward_calls == before + 3


# --- IG node and edge effects ------------------------------------------------


@pytest.fixture(scope="module")
def jax_nodes(models):
    """JAX's node effects on SUBMODULES, without and with a patch."""
    jcm = models[0]
    dicts = {s.name: jax_dict.IdentityDict(s.channels) for s in jcm.stages}
    x, patch = jnp.asarray(_images(0)), jnp.asarray(_images(5))
    return {kind: jax_attr.patching_effect(x, p, jcm, SUBMODULES[kind], dicts, LABEL, steps=STEPS)
            for kind, p in (("none", None), ("patch", patch))}


def _one_copy_a_chunk(monkeypatch):
    """A budget of one byte: every IG copy takes a pass of its own."""
    monkeypatch.setattr(attribution, "chunk_budget", lambda device: 1)


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("kind", ["none", "patch"])
def test_patching_effect_matches_jax(models, jax_nodes, kind, chunked, monkeypatch):
    _, pcm, _, _ = models
    dicts = {s.name: dictionary.IdentityDict(s.channels) for s in pcm.stages}
    patch = _images(5) if kind == "patch" else None
    if chunked:
        _one_copy_a_chunk(monkeypatch)
    got = attribution.patching_effect(_images(0), patch, pcm, SUBMODULES[kind], dicts, LABEL, steps=STEPS)
    want = jax_nodes[kind]
    for name in SUBMODULES[kind]:
        for field in ("effects", "grads", "deltas"):
            g, w = getattr(got, field)[name], getattr(want, field)[name]
            for part in ("act", "res", "resc"):
                if getattr(w, part) is None:
                    assert getattr(g, part) is None
                    continue
                _close(getattr(g, part), getattr(w, part), what=f"{name} {field}.{part}")
    if kind == "none":
        assert got.total_effect is None
    else:
        _close(got.total_effect, want.total_effect, what="total effect")
    assert np.abs(np.asarray(want.effects[SUBMODULES[kind][0]].act)).max() > 0


EDGE_CASES = [(pair, "none") for pair in PAIRS] + [(("avgpool", "resblock1"), "patch")]


@pytest.mark.parametrize("pair,kind", EDGE_CASES, ids=[f"{u}-{d}-{k}" for (u, d), k in EDGE_CASES])
def test_upstream_neuron_attribution_matches_jax(models, pair, kind, monkeypatch):
    jcm, pcm, _, _ = models
    up, down = pair
    channels = {s.name: s.channels for s in jcm.stages}
    up_idx = np.arange(channels[up])[::-1]
    down_idx = np.array([c for c in (0, 3, 5, 9) if c < channels[down]])
    x, patch = _images(0), (_images(5) if kind == "patch" else None)
    want = jax_attr.upstream_neuron_attribution(
        jnp.asarray(x), None if patch is None else jnp.asarray(patch), jcm, up, down,
        {s.name: jax_dict.IdentityDict(s.channels) for s in jcm.stages},
        upstream_neurons=up_idx, downstream_neurons=down_idx, steps=STEPS)
    dicts = {s.name: dictionary.IdentityDict(s.channels) for s in pcm.stages}
    for chunked in (False, True):
        if chunked:
            _one_copy_a_chunk(monkeypatch)
        got = attribution.upstream_neuron_attribution(x, patch, pcm, up, down, dicts, upstream_neurons=up_idx,
                                                      downstream_neurons=down_idx, steps=STEPS)
        assert got.shape == want.shape == (len(down_idx), len(up_idx))
        _close(got, want, what=f"{pair} chunked={chunked}")
    assert np.abs(want).max() > 0


def test_chunk_sizes_cover_every_copy(monkeypatch):
    cpu = torch.device("cpu")
    per = attribution.CPU_CHUNK_BYTES // attribution.BYTES_PER_ELEMENT
    assert attribution.chunk_sizes(10, per // 4, cpu) == [4, 3, 3]
    assert attribution.chunk_sizes(8, per // 4, cpu) == [4, 4]
    assert attribution.chunk_sizes(100, per // 10, cpu) == [10] * 10
    assert sum(attribution.chunk_sizes(1001, per // 7, cpu)) == 1001
    _one_copy_a_chunk(monkeypatch)
    assert attribution.chunk_sizes(3, 10, cpu) == [1, 1, 1]


def test_sparse_act_algebra():
    a = SparseAct(act=torch.tensor([1.0, 2.0]), res=torch.tensor([1.0, 1.0]))
    b = SparseAct(act=torch.tensor([3.0, 4.0]), res=torch.tensor([2.0, 2.0]))
    assert (a + b).act.tolist() == [4.0, 6.0] and (a - b).res.tolist() == [-1.0, -1.0]
    m = a @ b
    assert m.act.tolist() == [3.0, 8.0] and m.resc.tolist() == [4.0] and m.res is None
    assert (-a).act.tolist() == [-1.0, -2.0] and (a * 2).act.tolist() == [2.0, 4.0]
    assert (a / 2).res.tolist() == [0.5, 0.5] and a[1] == 2.0
    assert m.to_tensor().tolist() == [3.0, 8.0, 4.0] and a.to_tensor().shape == (4,)
    assert SparseAct(act=torch.ones(2, 3), res=torch.ones(2, 3)).sum(axis=1).act.tolist() == [3.0, 3.0]


# --- the class circuit --------------------------------------------------------


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _stable_cut(effect: np.ndarray, k: int) -> bool:
    """Whether the top-k order of |effect| is decided by more than the tolerance."""
    mags = np.sort(np.abs(effect))[::-1][: k + 1]
    return bool(np.all(np.diff(-mags) > 1e-4 * max(np.abs(effect).max(), 1e-30)))


def _compare_circuit_dirs(port_dir, jax_dir, label):
    nodes_p, nodes_j = _load(port_dir / f"{label}_nodes.npz"), _load(jax_dir / f"{label}_nodes.npz")
    feats_p = _load(port_dir / f"{label}_features_by_submod.npz")
    feats_j = _load(jax_dir / f"{label}_features_by_submod.npz")
    edges_p, edges_j = _load(port_dir / f"{label}_edges.npz"), _load(jax_dir / f"{label}_edges.npz")
    assert list(nodes_p) == list(nodes_j) and list(feats_p) == list(feats_j) and list(edges_p) == list(edges_j)
    stable = 0
    for name in nodes_j:
        _close(nodes_p[name], nodes_j[name], what=name)
        if _stable_cut(nodes_j[name], len(feats_j[name])):
            np.testing.assert_array_equal(feats_p[name], feats_j[name], err_msg=name)
            stable += 1
    assert stable >= len(nodes_j) - 2
    for key in edges_j:
        prev, cur = key.split("->")
        assert edges_p[key].shape == edges_j[key].shape, key
        d_p = {c: i for i, c in enumerate(feats_p[cur])}
        u_p = {c: i for i, c in enumerate(feats_p[prev])}
        rows = [(i, d_p[c]) for i, c in enumerate(feats_j[cur]) if c in d_p]
        cols = [(i, u_p[c]) for i, c in enumerate(feats_j[prev]) if c in u_p]
        assert rows and cols, key
        want = edges_j[key][np.ix_([r[0] for r in rows], [c[0] for c in cols])]
        got = edges_p[key][np.ix_([r[1] for r in rows], [c[1] for c in cols])]
        _close(got, want, what=key)
    return nodes_j, feats_j, edges_j


@pytest.fixture(scope="module")
def class_circuits(models, tmp_path_factory):
    """The identity-basis circuit of LABEL by both packages, files on disk."""
    jcm, pcm, _, _ = models
    root = tmp_path_factory.mktemp("circuits")
    x = _images(0)
    jax_circuits.compute_class_circuit(jcm, x, LABEL, node_threshold=THRESHOLD, steps=STEPS,
                                       out_folder=str(root / "jax"))
    circuits.compute_class_circuit(pcm, x, LABEL, node_threshold=THRESHOLD, steps=STEPS,
                                   out_folder=str(root / "port"))
    return root


def test_class_circuit_files_match_jax(class_circuits):
    nodes, feats, edges = _compare_circuit_dirs(class_circuits / "port", class_circuits / "jax", LABEL)
    assert len(nodes) == 10 and len(edges) == 9
    assert set(edges) == {f"{p}->{c}" for p, c in zip(list(nodes)[:-1], list(nodes)[1:])}
    assert [len(f) for f in feats.values()] == [1, 1, 1, 2, 2, 8, 16, 32, 64, 4]


def test_sae_basis_circuit_matches_jax(models, class_circuits, tmp_path):
    """A seeded SAE on resblock2, written as the .npz of its state dict and
    found by --sae_dir's resolution; the other stages in the neuron basis.
    The port's whole circuit of LABEL on the same images: what does not
    touch resblock2 is the identity-basis circuit's, bit for bit; resblock2's
    node effects (in the 2x wider feature basis) and the two edges into and
    out of it are held against JAX's on the port's selected features."""
    jcm, pcm, _, _ = models
    target = "resblock2"
    c = {s.name: s.channels for s in jcm.stages}[target]
    sae_params = jax.device_get(jax_sae.sae_init(jax.random.PRNGKey(1), jax_sae.SAECfg(c, 2 * c)))
    np.savez(tmp_path / f"{target}.npz", **jax_sae.sae_params_to_state_dict(sae_params))
    path = dictionary.resolve_sae_checkpoint(str(tmp_path), target)
    assert path == jax_dict.resolve_sae_checkpoint(str(tmp_path), target) and path.endswith(".npz")
    assert dictionary.resolve_sae_checkpoint(str(tmp_path), "resblock1") is None
    port_sae, jax_sae_dict = dictionary.load_sae_dictionary(path), jax_dict.load_sae_dictionary(path)
    assert port_sae.dict_size == jax_sae_dict.dict_size == 2 * c
    dicts = {s.name: port_sae if s.name == target else dictionary.IdentityDict(s.channels) for s in pcm.stages}
    jdicts = {s.name: jax_sae_dict if s.name == target else jax_dict.IdentityDict(s.channels) for s in jcm.stages}
    x = _images(0)
    nodes, feats, edges = circuits.compute_class_circuit(pcm, x, LABEL, node_threshold=THRESHOLD, steps=STEPS,
                                                         dictionaries=dicts, out_folder=str(tmp_path / "port"))
    ident_nodes = _load(class_circuits / "port" / f"{LABEL}_nodes.npz")
    ident_feats = _load(class_circuits / "port" / f"{LABEL}_features_by_submod.npz")
    ident_edges = _load(class_circuits / "port" / f"{LABEL}_edges.npz")
    for name in ident_nodes:
        if name != target:
            np.testing.assert_array_equal(nodes[name].act.numpy(), ident_nodes[name], err_msg=name)
            np.testing.assert_array_equal(feats[name], ident_feats[name], err_msg=name)
    for key, val in ident_edges.items():
        prev, cur = key.split("->")
        if target not in (prev, cur):
            np.testing.assert_array_equal(edges[prev][cur], val, err_msg=key)

    assert nodes[target].act.shape == (2 * c,) and feats[target].max() < 2 * c
    want = jax_attr.patching_effect(jnp.asarray(x), None, jcm, [target], jdicts, LABEL, steps=STEPS)
    _close(nodes[target].act, want.effects[target].sum(axis=1).mean(axis=0).act, what="nodes")
    for prev, cur in (("resblock1", target), (target, "resblock3")):
        want = jax_attr.upstream_neuron_attribution(jnp.asarray(x), None, jcm, prev, cur, jdicts,
                                                    upstream_neurons=feats[prev], downstream_neurons=feats[cur],
                                                    steps=STEPS)
        _close(edges[prev][cur], want, what=f"{prev}->{cur}")


def test_load_sae_dictionary_squeezes_one_component(tmp_path):
    params = sae_model.sae_init(torch.Generator().manual_seed(0), sae_model.SAECfg(8, 16, n_components=1))
    torch.save(sae_model.sae_params_to_state_dict(params), tmp_path / "s.pt")
    d = dictionary.load_sae_dictionary(str(tmp_path / "s.pt"))
    want = jax_dict.load_sae_dictionary(str(tmp_path / "s.pt"))
    assert d.params["encoder"]["weight"].shape == (16, 8) and d.params["tied_bias"].shape == (8,)
    x = np.random.RandomState(0).randn(3, 5, 8).astype(np.float32)
    _close(d.encode(torch.from_numpy(x)), want.encode(jnp.asarray(x)), atol=1e-6)
    f = np.abs(np.random.RandomState(1).randn(3, 5, 16)).astype(np.float32)
    _close(d.decode(torch.from_numpy(f)), want.decode(jnp.asarray(f)), atol=1e-6)
    for got, ref in zip(d.forward_for_sfc(torch.from_numpy(x)), want.forward_for_sfc(jnp.asarray(x))):
        _close(got, ref, atol=1e-6)


# --- graphs -------------------------------------------------------------------


def _graph_inputs(class_circuits):
    base = class_circuits / "jax"
    nodes, feats = _load(base / f"{LABEL}_nodes.npz"), _load(base / f"{LABEL}_features_by_submod.npz")
    edges = {}
    for key, val in _load(base / f"{LABEL}_edges.npz").items():
        p, c = key.split("->")
        edges.setdefault(p, {})[c] = val
    return nodes, edges, feats


@pytest.mark.parametrize("edge_k", [2, 3])
def test_graph_functions_match_networkx(class_circuits, tmp_path, monkeypatch, edge_k):
    nodes, edges, feats = _graph_inputs(class_circuits)
    g_p, g_j = graph.build_circuit_graph(nodes, edges, feats, edge_k), jax_graph.build_circuit_graph(
        nodes, edges, feats, edge_k)
    assert g_p.nodes(data=True) == list(g_j.nodes(data=True))
    assert g_p.edges(data=True) == list(g_j.edges(data=True))
    assert g_p.number_of_nodes() == g_j.number_of_nodes() and g_p.number_of_edges() == g_j.number_of_edges()
    assert all(g_p.degree(v) == g_j.degree(v) and g_p.neighbors(v) == list(g_j.neighbors(v)) for v in g_j.nodes)
    # a second graph: the same circuit's other edge_k
    other_p = graph.build_circuit_graph(nodes, edges, feats, 5 - edge_k)
    other_j = jax_graph.build_circuit_graph(nodes, edges, feats, 5 - edge_k)
    assert graph.jaccard_graph_similarity(g_p, other_p) == jax_graph.jaccard_graph_similarity(g_j, other_j)
    assert 0 < graph.jaccard_graph_similarity(g_p, other_p) < 1
    for node_label in (True, False):
        got = graph.wl_kernel_similarity([g_p, other_p, g_p], h=3, node_label=node_label)
        want = jax_graph.wl_kernel_similarity([g_j, other_j, g_j], h=3, node_label=node_label)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    rng = np.random.RandomState(edge_k)
    a, b = rng.randn(40), rng.randn(40)
    for fraction in (0.1, 0.25):
        assert graph.node_jaccard_similarity(a, b, fraction) == jax_graph.node_jaccard_similarity(a, b, fraction)
    # the renderer's DOT source, as JAX saves it when graphviz cannot render
    import graphviz

    def no_binaries(*args, **kwargs):
        raise graphviz.ExecutableNotFound(("dot",))

    monkeypatch.setattr(graphviz.Digraph, "render", no_binaries)
    got_path = graph.render_circuit_graphviz(g_p, str(tmp_path / "port"))
    want_path = jax_graph.render_circuit_graphviz(g_j, str(tmp_path / "jax"))
    assert got_path.endswith(".dot") and want_path.endswith(".dot")
    with open(got_path, "rb") as fa, open(want_path, "rb") as fb:
        assert fa.read() == fb.read()


def test_dot_quoting_matches_graphviz(tmp_path):
    import graphviz

    g = graph.DiGraph()
    g.add_node("node", effect=0.0, node_label="0")
    g.add_node('q"uote', effect=-2.0)
    g.add_edge("x_1", "-2.5", weight=0.1)
    g.add_edge("node", 'q"uote', weight=-3.0)
    with open(graph.render_circuit_graphviz(g, str(tmp_path / "g"))) as fh:
        text = fh.read()
    dot = graphviz.Digraph(name="Feature circuit")
    dot.graph_attr.update(rankdir="BT", newrank="true")
    dot.node_attr.update(shape="box", style="rounded,filled")
    for node, fill, fc in (("node", "#FFFFFF", "#000000"), ('q"uote', "#FF0000", "#ffffff"),
                           ("x_1", "#FFFFFF", "#000000"), ("-2.5", "#FFFFFF", "#000000")):
        dot.node(node, label=node, fillcolor=fill, fontcolor=fc)
    dot.edge("node", 'q"uote', penwidth="3.0")  # the edges in the order of their tails
    dot.edge("x_1", "-2.5", penwidth="0.3")
    assert text == dot.source



# --- CKA ------------------------------------------------------------------------


@pytest.mark.parametrize("n", [12, 13])
def test_cka_matches_jax_in_float64(n):
    rng = np.random.RandomState(n)
    x = rng.randn(n, 6)
    y = x @ rng.randn(6, 5) + 0.5 * rng.randn(n, 5)
    k, l = x @ x.T, y @ y.T
    with jax.enable_x64(True):
        for fn in ("hsic0", "hsic1"):
            np.testing.assert_allclose(float(getattr(cka, fn)(torch.from_numpy(k), torch.from_numpy(l))),
                                       float(getattr(jax_cka, fn)(jnp.asarray(k), jnp.asarray(l))), rtol=1e-12)
        for hsic, jhsic in ((cka.hsic1, jax_cka.hsic1), (cka.hsic0, jax_cka.hsic0)):
            np.testing.assert_allclose(cka.linear_cka(x, y, hsic), jax_cka.linear_cka(x, y, jhsic), rtol=1e-12)
            np.testing.assert_allclose(cka.kernel_cka(x, y, hsic), jax_cka.kernel_cka(x, y, jhsic), rtol=1e-12)
            np.testing.assert_allclose(cka.kernel_cka(x, y, hsic, sigma=2.0),
                                       jax_cka.kernel_cka(x, y, jhsic, sigma=2.0), rtol=1e-12)
        np.testing.assert_allclose(cka.rbf_kernel(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_cka.rbf_kernel(jnp.asarray(x))), rtol=1e-12, atol=1e-15)
    assert cka.linear_cka(x, x) == pytest.approx(1.0, abs=1e-12)
    labels = rng.randint(0, 4, n)
    np.testing.assert_array_equal(cka.class_mean_activations(x, labels), jax_cka.class_mean_activations(x, labels))


def test_rbf_bandwidth_is_the_averaged_median():
    """An even count of squared distances (n = 12: 144) whose two middle
    values differ: the bandwidth averages them (np.median, jnp.median), where
    torch.median would take the lower one."""
    x = torch.from_numpy(np.random.RandomState(12).randn(12, 6))
    gram = x @ x.T
    sq = torch.diagonal(gram)
    dists = sq[:, None] - 2 * gram + sq[None, :]
    v = dists.flatten().sort().values
    assert v[71] != v[72]
    assert float(cka.median(dists)) == pytest.approx(float(np.median(dists.numpy())), rel=1e-15)
    assert float(torch.median(dists)) != float(cka.median(dists))
    assert float(cka.median(torch.tensor([3.0, 1.0, 2.0]))) == 2.0


# --- feature sharing and concept naming --------------------------------------


def test_feature_sharing_matches_jax(tmp_path):
    jparams = jax.device_get(jax_sae.sae_init(jax.random.PRNGKey(0), jax_sae.SAECfg(16, 64, n_components=1)))
    rng = np.random.RandomState(0)
    n = 90
    feats = rng.randn(n, 16).astype(np.float32)
    labels = np.repeat([0, 11, 13], n // 3)
    domain_ids = np.tile([0, 4, 5], n // 3)
    classes = {"aircraft carrier": 0, "axe": 11, "banana": 13}
    want = jax_fs.evaluate_feature_sharing(jparams, feats, labels, domain_ids, classes, domain="sketch",
                                           out_path=str(tmp_path / "jax"), n_learned_features=64)
    got = feature_sharing.evaluate_feature_sharing(sae_model.sae_params_from_numpy(jparams), feats, labels,
                                                   domain_ids, classes, domain="sketch",
                                                   out_path=str(tmp_path / "port"), n_learned_features=64)
    assert got == want
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(files) == 3 * 6 + 1
    for name in files:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name))
    with open(tmp_path / "port" / "feature-sharing.json") as fa, open(tmp_path / "jax" / "feature-sharing.json") as fb:
        assert json.load(fa) == json.load(fb)
    a, b = rng.rand(50), rng.rand(50)
    assert feature_sharing.mpct_shared(a, b) == jax_fs.mpct_shared(a, b)


@pytest.mark.parametrize("config", ["lr0.0005_l1coeff3e-05_ef8_rf5_hookout_bs4096_epo200", "ef4_lr1e-3", "bad1"])
def test_decode_sae_config_matches_jax(config):
    try:
        want = jax_naming.decode_sae_config(config)
    except ValueError:
        with pytest.raises(ValueError):
            naming.decode_sae_config(config)
        return
    assert naming.decode_sae_config(config) == want


def test_concept_names_match_jax(models, tmp_path):
    """The vocabulary through both text towers, then DiscoverThenName with
    one seeded SAE (components axis of 1): names, CSV and load."""
    _, pcm, jmodel, params = models
    vocab = ["dog", "a red barn", "lion", "pizza", "tractor", "sketch", "mountain", "necklace", "zebra"]
    tok = SimpleTokenizer(context_length=16)

    def folded(texts):  # the BPE ids folded into the tiny vocabulary of 256
        return tok(texts) % 256

    assert (folded(vocab) == jax_tokenize(vocab, context_length=16) % 256).all()
    got_emb = naming.embed_vocab(pcm.model, folded, vocab, batch_size=4)
    want_emb = jax_naming.embed_vocab(jmodel, params, folded, vocab, batch_size=4)
    _close(got_emb, want_emb, rtol=0, atol=1e-5)
    jparams = jax.device_get(jax_sae.sae_init(jax.random.PRNGKey(2), jax_sae.SAECfg(16, 48, n_components=1)))
    want = jax_naming.DiscoverThenName(jparams, want_emb, vocab)
    got = naming.DiscoverThenName(sae_model.sae_params_from_numpy(jparams), want_emb, vocab)
    _close(got.get_concept_name_similarity_matrix(), want.get_concept_name_similarity_matrix(), rtol=0, atol=1e-6)
    assert got.get_concept_names() == want.get_concept_names()
    x = np.random.RandomState(0).randn(5, 16).astype(np.float32)
    _close(got.get_concepts_from_features(x), want.get_concepts_from_features(x[:, None, :]), rtol=0, atol=1e-6)
    (tmp_path / "p").mkdir()
    names = got.write_concept_names_csv(str(tmp_path / "p" / "concepts" / "concept_names.csv"))
    want.write_concept_names_csv(str(tmp_path / "j" / "concepts" / "concept_names.csv"))
    assert (tmp_path / "p" / "concepts" / "concept_names.csv").read_text() == \
           (tmp_path / "j" / "concepts" / "concept_names.csv").read_text()
    assert naming.load_concept_names(str(tmp_path / "p")) == jax_naming.load_concept_names(str(tmp_path / "j")) == names
    assert len(names) == 48 and math.isfinite(float(got_emb.sum()))

