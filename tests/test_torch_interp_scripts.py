"""The port's interpretability CLIs on the CPU, against the JAX scripts.

A seeded tiny RN CLIP (``tests/test_script_clis.py``'s ``TINY_RN``, random
BatchNorms) is saved once as an open_clip ``.pt`` that both packages load,
beside a seeded DomainNet tree of six domains (classes 0-11, one 32-px JPEG
each, class 0 three times in real and sketch). Tolerances:

- ``compute_circuits``: its files equal, bit for bit, the port's
  ``compute_class_circuit`` on the same images and zero-shot head (the
  library is held against JAX in ``tests/test_torch_interp.py``);
- ``compute_node_similarity`` and ``compute_circuit_similarity``
  (``jaccard``, ``wl``): the JSON equal to the JAX scripts' on the same
  circuit files (WL within 1e-12);
- ``representational_analysis``: ``cka_linear.json`` within rel 1e-3 (abs
  1e-5) of the JAX script's with x64 enabled on the same pooled
  activations (the estimator cancels badly on a tiny random tower; see
  the test);
- ``analyze_sae_features`` and ``name_concepts``: the histograms, JSON and
  concept names equal to the JAX scripts', the vocabulary embeddings within
  1e-5.
"""

import argparse
import importlib.util
import json
import math
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import xclip_tpu.models.factory as jax_factory
from test_torch_models import release_memory_after_module  # noqa: F401
from xclip_tpu_torch.evals.zero_shot import OpenAIZeroShotClassifier
from xclip_tpu_torch.interp.circuit_model import VisualCircuitModel
from xclip_tpu_torch.interp.circuits import compute_class_circuit
from xclip_tpu_torch.models import factory
from xclip_tpu_torch.models.resnet import resnet_stage_names
from xclip_tpu_torch.sae import model as sae_model
from xclip_tpu_torch.scripts import (
    analyze_sae_features,
    compute_circuit_similarity,
    compute_circuits,
    compute_node_similarity,
    name_concepts,
    representational_analysis,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
DOMAINS = ["clipart", "infograph", "painting", "quickdraw", "real", "sketch"]
NAME = "TinyInterpRN"
N_CLASSES = 12
TINY_RN = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "layers": [1, 1, 1, 1], "width": 8, "patch_size": None},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 16, "heads": 2, "layers": 1},
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread_and_configs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    factory._MODEL_CONFIGS[NAME] = TINY_RN
    jax_factory._MODEL_CONFIGS[NAME] = TINY_RN
    yield
    del factory._MODEL_CONFIGS[NAME], jax_factory._MODEL_CONFIGS[NAME]
    torch.set_num_threads(n)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, SCRIPTS)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(SCRIPTS)
    return mod


_JAX_MODELS = {}


def _jax_create_model(model_name, pretrained, precision="fp32"):
    """JAX's ``create_model`` for an fp32 ``.pt``, with one model a config
    whose ``init`` (also called by JAX's checkpoint loader) is jitted: the
    eager init's first call takes ~10 s of op compiles here. The checkpoint
    sets every parameter."""
    from xclip_tpu.core.checkpoint import load_checkpoint
    from xclip_tpu.models.clip import CLIPModel

    assert precision == "fp32"
    if model_name not in _JAX_MODELS:
        model = CLIPModel(jax_factory.get_clip_cfg(model_name))
        object.__setattr__(model, "init", jax.jit(model.init))  # a frozen dataclass
        _JAX_MODELS[model_name] = model
    model = _JAX_MODELS[model_name]
    return (model, *load_checkpoint(pretrained, model, *model.init(jax.random.PRNGKey(0))))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(root, model_dir, checkpoint): the DomainNet tree and the .pt."""
    root = tmp_path_factory.mktemp("interp_cli")
    rng = np.random.RandomState(0)
    for domain in DOMAINS:
        rows = []
        for c in range(N_CLASSES):
            for j in range(3 if c == 0 and domain in ("real", "sketch") else 1):
                rel = f"{domain}/cls{c}/{j}.jpg"
                (root / "dn" / domain / f"cls{c}").mkdir(parents=True, exist_ok=True)
                # a random colour with some noise: class means far apart
                img = rng.randint(0, 200, (1, 1, 3)) + rng.randint(0, 56, (32, 32, 3))
                Image.fromarray(img.astype(np.uint8)).save(root / "dn" / rel)
                rows.append(f"{rel}\t{c}\ta photo.")
        (root / "dn" / f"{domain}_test.tsv").write_text("\n".join(rows) + "\n")
    model = factory.create_model(NAME, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    sd = model.state_dict()
    for key, val in sd.items():
        if ".bn" in key or "downsample.1" in key or key.startswith("visual.bn"):
            if key.endswith(("weight", "running_var")):
                sd[key] = torch.rand(val.shape, generator=gen) + 0.5
            elif key.endswith(("bias", "running_mean")):
                sd[key] = torch.randn(val.shape, generator=gen) * 0.1
    (root / "model" / "checkpoints").mkdir(parents=True)
    ckpt = root / "model" / "checkpoints" / "epoch_32.pt"
    torch.save({"epoch": 32, "name": NAME, "state_dict": sd}, ckpt)
    return root, root / "model", ckpt


@pytest.fixture(scope="module")
def circuit_dirs(tree):
    """compute_circuits (the port's CLI) for class 0 in real and sketch."""
    root, model_dir, _ = tree
    for domain in ("real", "sketch"):
        assert compute_circuits.main(["--model", NAME, "--model_dir", str(model_dir), "--domain", domain,
                                      "--class_idx", "0", "--domainnet_path", str(root / "dn"), "--seed", "0",
                                      "--samples_per_class", "3", "--node_threshold", "0.25",
                                      "--device", "cpu"]) == 0
    return model_dir / "circuit_analysis"


def test_compute_circuits_cli_equals_the_library(tree, circuit_dirs, tmp_path):
    """The CLI's files against compute_class_circuit on the images the CLI
    picks (python's random, seeded with 0, shuffles the class's indices) and
    the same 86-template head."""
    import random

    from xclip_tpu_torch.data.datasets import DomainNetCaptions
    from xclip_tpu_torch.data.transforms import image_transform
    from xclip_tpu_torch.evals.lso import domainnet_classes_from_samples
    from xclip_tpu_torch.tokenizer import get_tokenizer

    root, _, ckpt = tree
    model = factory.create_model(NAME, pretrained=str(ckpt), device="cpu")
    tf = image_transform(32, is_train=False)
    ref = DomainNetCaptions(str(root / "dn"), "val", tf, exclude_domains=[d for d in DOMAINS if d != "real"])
    clf = OpenAIZeroShotClassifier(model, get_tokenizer(NAME), domainnet_classes_from_samples(ref.samples))
    cm = VisualCircuitModel(model, clf.prompt_feat)
    for domain in ("real", "sketch"):  # one CLI run per domain, each seeding python's random
        random.seed(0)
        data = DomainNetCaptions(str(root / "dn"), "val", tf, exclude_domains=[d for d in DOMAINS if d != domain])
        indices = [i for i, s in enumerate(data.samples) if s[1] == 0]
        random.shuffle(indices)
        images = np.stack([data[i][0] for i in indices])
        compute_class_circuit(cm, images, 0, node_threshold=0.25, out_folder=str(tmp_path / domain))
        for suffix in ("nodes", "features_by_submod", "edges"):
            with np.load(circuit_dirs / domain / f"0_{suffix}.npz") as got, \
                    np.load(tmp_path / domain / f"0_{suffix}.npz") as want:
                assert got.files == want.files and len(got.files) == (9 if suffix == "edges" else 10)
                for key in want.files:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=f"{domain} {suffix} {key}")


def test_similarity_clis_match_jax(circuit_dirs, tmp_path):
    model_dir = str(circuit_dirs.parent)
    assert compute_node_similarity.main(["--model_dir", model_dir, "--out_path", str(tmp_path / "port")]) == 0
    _load_script("compute_node_similarity").main(argparse.Namespace(model_dir=model_dir,
                                                                     out_path=str(tmp_path / "jax")))
    with open(tmp_path / "port" / "node_similarity.json") as fa, open(tmp_path / "jax" / "node_similarity.json") as fb:
        got, want = json.load(fa), json.load(fb)
    assert got == want and len(got["all"]) == 9 and set(got["all"]["resblock2"]) == {"real|sketch"}
    jax_cs = _load_script("compute_circuit_similarity")
    for metric in ("jaccard", "wl"):
        assert compute_circuit_similarity.main(["--model_dir", model_dir, "--out_path", str(tmp_path / "port"),
                                                "--metric", metric, "--edge_k", "2",
                                                "--wl_iterations", "2"]) == 0
        jax_cs.main(argparse.Namespace(model_dir=model_dir, out_path=str(tmp_path / "jax"), metric=metric,
                                       edge_k=2, wl_iterations=2))
        name = f"circuit_similarity_{metric}.json"
        with open(tmp_path / "port" / name) as fa, open(tmp_path / "jax" / name) as fb:
            got, want = json.load(fa), json.load(fb)
        assert set(got) == set(want) and set(got["all"]) == {"real|sketch"} and got["id"] == want["id"] == {}
        for split in want:
            for pair in want[split]:
                assert got[split][pair] == pytest.approx(want[split][pair], abs=1e-12)


def test_representational_analysis_cli_matches_jax(tree, tmp_path, monkeypatch):
    """cka_linear.json against the JAX script run with x64 on the port's
    pooled activations (the stage activations themselves are held against
    JAX in tests/test_torch_interp.py), rel 1e-3 / abs 1e-5: on a tiny
    random tower the unbiased HSIC1 of 12 class means cancels badly
    (noise images gave hsic(K, K) ~1e-9 against grams of O(1), where fp32
    rounding of the activations moved the CKA by 4e-4 to 5e-3); colour
    images keep the class means apart, and float64 summation order alone
    then moves the CKAs near 0 by up to 3e-6."""
    from xclip_tpu_torch.data.datasets import DomainNetCaptions
    from xclip_tpu_torch.data.transforms import image_transform

    root, model_dir, ckpt = tree
    port_acts, capture = {}, representational_analysis.capture_pooled_activations

    def recording_capture(model, dataset, batch_size, num_threads):
        port_acts[dataset.samples[0][0].split("/")[-3]] = out = capture(model, dataset, batch_size, num_threads)
        return out

    monkeypatch.setattr(representational_analysis, "capture_pooled_activations", recording_capture)
    assert representational_analysis.main(["--model", NAME, "--model_dir", str(model_dir),
                                           "--domainnet_path", str(root / "dn"), "--out_path", str(tmp_path / "p"),
                                           "--batch_size", "8", "--num_workers", "2", "--device", "cpu"]) == 0
    assert sorted(port_acts) == sorted(DOMAINS)
    jax_script = _load_script("representational_analysis")
    acts, labels = port_acts["sketch"]
    assert list(acts) == resnet_stage_names(factory.get_clip_cfg(NAME).vision) and labels.shape == (N_CLASSES + 2,)
    assert acts["layer1.0"].shape == (N_CLASSES + 2, 32) and acts["attnpool"].shape == (N_CLASSES + 2, 16)
    model = factory.create_model(NAME, pretrained=str(ckpt), device="cpu")
    want_sketch = capture(model, DomainNetCaptions(str(root / "dn"), "val", image_transform(32),
                                                   exclude_domains=[e for e in DOMAINS if e != "sketch"]), 5, 2)
    for layer, value in want_sketch[0].items():  # the CLI's capture is the library's at any batch size
        np.testing.assert_allclose(acts[layer], value, rtol=0, atol=1e-6, err_msg=layer)
    np.testing.assert_array_equal(labels, want_sketch[1])

    def port_capture(model, params, state, dataset, batch_size, num_threads):
        return port_acts[dataset.samples[0][0].split("/")[-3]]

    monkeypatch.setattr(jax_script, "capture_pooled_activations", port_capture)
    monkeypatch.setattr(jax_script, "create_model", _jax_create_model)
    with jax.enable_x64(True):
        jax_script.main(argparse.Namespace(model=NAME, model_dir=str(model_dir), domainnet_path=str(root / "dn"),
                                           out_path=str(tmp_path / "j"), kernel="linear", batch_size=8,
                                           num_workers=2))
    with open(tmp_path / "p" / "cka_linear.json") as fa, open(tmp_path / "j" / "cka_linear.json") as fb:
        got, want = json.load(fa), json.load(fb)
    assert set(got) == set(want) == {"all", "ood", "id"}
    assert got["ood"] == {k: {} for k in want["ood"]} and len(got["all"]) == 9
    finite = 0
    for split in ("all", "id"):
        for layer, pairs in want[split].items():
            assert set(got[split][layer]) == set(pairs) and len(pairs) == 15
            for pair, value in pairs.items():
                # HSIC1 is unbiased: with few classes hsic(K, K) can be
                # negative and the CKA NaN, then in both packages
                assert got[split][layer][pair] == pytest.approx(value, rel=1e-3, abs=1e-5, nan_ok=True), (split, layer, pair)
                finite += math.isfinite(value)
    assert finite >= 100


def test_analyze_sae_features_cli_matches_jax(tree, tmp_path):
    root, _, ckpt = tree
    params = sae_model.sae_init(torch.Generator().manual_seed(3), sae_model.SAECfg(16, 32, n_components=1))
    (tmp_path / "sae" / "checkpoints").mkdir(parents=True)
    torch.save(sae_model.sae_params_to_state_dict(params), tmp_path / "sae" / "checkpoints" /
               "sparse_autoencoder_final.pt")
    common = dict(ckpt_path=str(ckpt), sae_path=str(tmp_path / "sae"), domainnet_path=str(root / "dn"),
                  domain="sketch", input_dim=16, expansion_factor=2)
    # the port's loader decodes in the calling process with 0 workers (no
    # spawned processes); JAX's thread pool needs at least one thread
    assert analyze_sae_features.main(["--model", NAME, "--out_path", str(tmp_path / "p"), "--device", "cpu",
                                      "--num_workers", "0"] + [f"--{k}={v}" for k, v in common.items()]) == 0
    jax_script = _load_script("analyze_sae_features")
    jax_script.create_model = _jax_create_model
    jax_script.main(argparse.Namespace(model=NAME, out_path=str(tmp_path / "j"), num_workers=2, **common))
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "p")) and len(files) == 15 * 6 + 1
    for name in files:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "p" / name), np.load(tmp_path / "j" / name), name)
    with open(tmp_path / "p" / "feature-sharing.json") as fa, open(tmp_path / "j" / "feature-sharing.json") as fb:
        assert json.load(fa) == json.load(fb)
    assert 0 < np.load(tmp_path / "p" / "aircraft carrier_sketch_hist.npy").sum() <= 3 * 20


def test_name_concepts_cli_matches_jax(tree, tmp_path):
    _, _, ckpt = tree
    params = sae_model.sae_init(torch.Generator().manual_seed(4), sae_model.SAECfg(16, 32, n_components=1))
    vocab = tmp_path / "words.txt"
    vocab.write_text("\n".join(["dog", "a red barn", "lion", "pizza", "tractor", "sketch of a cat", "zebra"]) + "\n")
    for side in ("p", "j"):
        (tmp_path / side / "checkpoints").mkdir(parents=True)
        torch.save(sae_model.sae_params_to_state_dict(params),
                   tmp_path / side / "checkpoints" / "sparse_autoencoder_final.pt")
    common = dict(img_enc_name=NAME, vocab_file=str(vocab), ckpt_path=str(ckpt), input_dim=16, expansion_factor=2)
    assert name_concepts.main(["--out_dir", str(tmp_path / "p"), "--device", "cpu"]
                              + [f"--{k}={v}" for k, v in common.items()]) == 0
    jax_script = _load_script("name_concepts")
    jax_script.create_model = _jax_create_model
    jax_script.main(argparse.Namespace(out_dir=str(tmp_path / "j"), hook_points=["out"], **common))
    got = np.load(tmp_path / "p" / "concepts" / "embeddings_words.npy")
    want = np.load(tmp_path / "j" / "concepts" / "embeddings_words.npy")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got_csv = (tmp_path / "p" / "concepts" / "concept_names.csv").read_text()
    assert got_csv == (tmp_path / "j" / "concepts" / "concept_names.csv").read_text()
    assert len(got_csv.splitlines()) == 32
