"""The port's supervised classifier baseline against the JAX package on the CPU.

Tiny backbones (an RN with layers (1,1,1,1), width 16, 64 px; a 2-layer
ViT of width 64, head dim 32, patch 8 on 32 px) are registered under the
same names in both factories, and both packages' ``ClassifierCfg`` get
``backbone_name`` and ``feature_dim`` from ``monkeypatch`` (never from the
class defaults: a pre-port test sets them on JAX's class and restores only
one). The port's classifier is initialised from a seed, its BatchNorms
randomised, and its weights carried into JAX's pytrees with the port's
bridge (``core.checkpoint.classifier_pytrees_from_state_dict``); JAX's
random init is traced for its shapes only (run eagerly on the CPU it
takes about 20 s for the tiny RN). Everything is fp32, so the tolerances
cover summation order.

Also the pieces: the per-step schedule, the decayed tensors, the ``.npz``
format both ways, predictions with a ragged last batch, the supervised
evaluator's ``results.json`` and the training CLI's files against JAX's
scripts, the launchers' commands; and RN50 and ViT-B-32 at full width,
bridged from JAX's seeded init, against ``tests/goldens/``.
"""

import importlib.util
import json
import os
import stat
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from test_torch_models import release_memory_after_module  # noqa: F401
from xclip_tpu.core.checkpoint import flatten_pytree as jax_flatten_pytree
from xclip_tpu.models import factory as jax_factory
from xclip_tpu.parallel.mesh import create_mesh
from xclip_tpu.train import learner as jax_learner
from xclip_tpu.train import optim as jax_optim
from xclip_tpu_torch.core import checkpoint as port_ckpt
from xclip_tpu_torch.core.checkpoint import classifier_pytrees_from_state_dict, state_dict_from_jax_params
from xclip_tpu_torch.models import factory
from xclip_tpu_torch.scripts import evaluate_domainnet_supervised_lso as port_sup_eval
from xclip_tpu_torch.scripts import train_combined_captions as port_train_cli
from xclip_tpu_torch.train import learner, optim, schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
TEXT = {"context_length": 16, "vocab_size": 1000, "width": 32, "heads": 2, "layers": 1}
BACKBONES = {
    "rn": ("TinySupRN", {"embed_dim": 32, "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 16,
                                                          "patch_size": None}, "text_cfg": TEXT}),
    "vit": ("TinySupViT", {"embed_dim": 32, "vision_cfg": {"image_size": 32, "patch_size": 8, "width": 64,
                                                           "layers": 2, "head_width": 32}, "text_cfg": TEXT}),
}
FEATURE_DIM = 32
N_CLASSES = 7
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op torch thread: the suite runs several workers on a shared
    CPU, where torch's thread pool stalls on preempted threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _register(monkeypatch, kind: str) -> str:
    """Register the tiny backbone ``kind`` in both factories and point both
    packages' ``ClassifierCfg`` at it; returns its name."""
    name, cfg = BACKBONES[kind]
    monkeypatch.setitem(jax_factory._MODEL_CONFIGS, name, cfg)
    monkeypatch.setitem(factory._MODEL_CONFIGS, name, cfg)
    for cls in (jax_learner.ClassifierCfg, learner.ClassifierCfg):
        monkeypatch.setattr(cls, "backbone_name", property(lambda self, n=name: n))
        monkeypatch.setattr(cls, "feature_dim", property(lambda self: FEATURE_DIM))
    return name


def _shape_init(monkeypatch):
    """JAX's ``Classifier.init`` traced for its pytree structure and shapes
    only (zeros): ``load_classifier`` takes nothing else from it."""
    init = jax_learner.Classifier.init

    def shape_init(self, rng):
        shapes = jax.eval_shape(lambda r: init(self, r), rng)
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    monkeypatch.setattr(jax_learner.Classifier, "init", shape_init)


def _randomize_bn(model, seed: int) -> None:
    """Random BatchNorm scales, biases and running statistics (the init's
    zero bn3 scale would hide the bottlenecks' convs), in place."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=gen) + 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen) * 0.1)
                mod.running_mean.copy_(torch.randn(mod.running_mean.shape, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(mod.running_var.shape, generator=gen) + 0.5)


def _models(seed=0, num_classes=N_CLASSES, **cfg_kw):
    """(port classifier, JAX classifier, JAX params, JAX state): the port's
    seeded weights carried into JAX's pytrees."""
    model = learner.create_classifier(learner.ClassifierCfg(num_classes=num_classes, **cfg_kw), device="cpu",
                                      seed=seed)
    _randomize_bn(model, seed + 1)
    params, state = classifier_pytrees_from_state_dict(model.state_dict(), model.clip_cfg)
    jm = jax_learner.Classifier(jax_learner.ClassifierCfg(num_classes=num_classes, **cfg_kw))
    return model, jm, params, state


def _images(n, size, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(np.float32)


@pytest.mark.parametrize("kind", ["rn", "vit"])
def test_classifier_pytrees_match_jax_init(kind, monkeypatch):
    """The bridge's pytrees have exactly the paths, shapes and dtypes of JAX's
    ``Classifier.init`` (JAX's ``unflatten_into`` refuses anything else)."""
    _register(monkeypatch, kind)
    model, jm, params, state = _models()
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    got = {k: (v.shape, v.dtype) for k, v in jax_flatten_pytree({"params": params, "state": state}).items()}
    ref = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): (tuple(leaf.shape), leaf.dtype)
           for path, leaf in jax.tree_util.tree_flatten_with_path({"params": want[0], "state": want[1]})[0]}
    assert got == ref


@pytest.mark.parametrize("kind", ["rn", "vit"])
def test_classifier_logits_match_jax(kind, monkeypatch):
    """Eval-mode logits of the port and of JAX's ``Classifier.apply`` on
    the same weights and images; and the way back through
    ``classifier_state_dict_from_pytrees`` gives the port's state dict."""
    _register(monkeypatch, kind)
    model, jm, params, state = _models()
    x = _images(5, model.image_size)
    want, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x))(params, state, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
    back = port_ckpt.classifier_state_dict_from_pytrees(params, state, model.clip_cfg)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(back[k], v, atol=0, rtol=0)


def test_classifier_train_steps_match_jax(monkeypatch):
    """Three fp32 SGD steps of the tiny RN classifier (8 images a step,
    ``steps_per_epoch=1``, milestone 2: the learning rate drops 10x at step
    2) against JAX's ``make_classifier_train_step`` on a one-device mesh:
    loss and accuracy per step, and every parameter and BatchNorm running
    statistic after steps 1 and 3.

    Tolerances. The loss rtol 1e-5 at step 1 and 1e-3 after (the steps then
    start from weights that differ in their last bits). This tiny model's
    train-mode gradient amplifies differences in the BatchNorm batch
    statistics about 1000-fold: JAX sums them in fp32 in order (its stem
    BatchNorm output is 8.4e-6 off a float64 evaluation; the port's, in
    float64, 1e-14), and the first step's conv gradients of the two
    packages then differ by up to 5 % of their largest element (the port's
    fp32 gradients stay where its float64 ones are). So the learning rate
    is 1e-3, where a step moves each weight by about 1e-3 of its scale.
    Held, of each tensor's largest element: the parameters to 3e-4 after
    step 1 and 3e-3 after step 3 (measured: 9.2e-5 and 8.4e-4), the
    running statistics to 1e-5 and 1e-3 (1.4e-6 and 2.3e-4). The update
    rule itself is held on equal gradients by
    ``test_sgd_matches_optax_on_equal_gradients``."""
    _register(monkeypatch, "rn")
    cfg_kw = dict(lr=1e-3, milestones=(2,), gamma=0.1)
    model, jm, params, state = _models(**cfg_kw)
    model.train()
    step, optimizer = learner.make_classifier_train_step(model, steps_per_epoch=1, precision="fp32")
    jstep, tx = jax_learner.make_classifier_train_step(jm, create_mesh(jax.devices()[:1]), steps_per_epoch=1,
                                                       precision="fp32")
    p, s = jax.device_put((params, state))
    opt = tx.init(p)
    rng = np.random.RandomState(3)
    worst = {}
    for i in range(3):
        images = _images(8, 64, seed=10 + i)
        labels = rng.randint(0, N_CLASSES, 8).astype(np.int32)
        p, s, opt, m = jstep(p, s, opt, {"images": images, "labels": labels})
        got = step(torch.from_numpy(images), torch.from_numpy(labels))
        np.testing.assert_allclose(float(got["loss"]), float(m["loss"]), rtol=1e-5 if i == 0 else 1e-3)
        assert float(got["accuracy"]) == float(m["accuracy"])
        if i in (0, 2):
            want = port_ckpt.classifier_state_dict_from_pytrees(jax.device_get(p), jax.device_get(s),
                                                                model.clip_cfg)
            for k, v in model.state_dict().items():
                if k.endswith("num_batches_tracked"):
                    assert int(v) == i + 1, k
                    continue
                err = float((v - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-3)
                worst[(i, "running" in k)] = max(worst.get((i, "running" in k), 0.0), err)
    # step 1, step 3; parameters, running statistics
    assert worst[(0, False)] < 3e-4 and worst[(0, True)] < 1e-5, worst
    assert worst[(2, False)] < 3e-3 and worst[(2, True)] < 1e-3, worst
    assert [g["lr"] for g in optimizer.param_groups] == [schedule.piecewise_constant(1e-3, {2: 0.1})(2)] * 2


_RANK_CODE = """
import json, os, sys
import numpy as np, torch, torch.distributed as dist
spec = json.load(open(sys.argv[1]))
from xclip_tpu_torch.models import factory
from xclip_tpu_torch.parallel.distributed import init_distributed_from_env
from xclip_tpu_torch.train import learner
factory._MODEL_CONFIGS[spec["name"]] = spec["cfg"]
learner.ClassifierCfg.backbone_name = property(lambda self: spec["name"])
learner.ClassifierCfg.feature_dim = property(lambda self: spec["feature_dim"])
torch.set_num_threads(1)
rank = int(os.environ["RANK"])
init_distributed_from_env(None, torch.device("cpu"))
model = learner.create_classifier(learner.ClassifierCfg(num_classes=spec["classes"], lr=spec["lr"],
                                                        milestones=(2,)), device="cpu").train()
model.load_state_dict(torch.load(spec["weights"], weights_only=True))
step, _ = learner.make_classifier_train_step(model, steps_per_epoch=1, precision="fp32", group=dist.group.WORLD)
data = np.load(spec["data"])
metrics = []
for i in range(data["images"].shape[0]):
    rows = slice(rank * 4, rank * 4 + 4)
    m = step(torch.from_numpy(data["images"][i, rows]), torch.from_numpy(data["labels"][i, rows]))
    metrics.append([float(m["loss"]), float(m["accuracy"])])
torch.save({"metrics": metrics, "state": model.state_dict()}, os.path.join(spec["out"], f"rank{rank}.pt"))
dist.destroy_process_group()
"""


def test_classifier_step_data_parallel_matches_jax(monkeypatch, tmp_path):
    """Two fp32 steps of the tiny RN classifier as two gloo ranks (child
    processes, torch and the port only; 4 of each step's 8 images a rank)
    against JAX's step on a 2-device mesh: the loss and accuracy averaged
    over the ranks, every parameter and the running statistics (each
    rank's batch statistics, averaged) as in the one-device test, and the
    two ranks' states bit for bit equal."""
    import socket

    name = _register(monkeypatch, "rn")
    model, jm, params, state = _models(lr=1e-3, milestones=(2,))
    torch.save(model.state_dict(), tmp_path / "w.pt")
    rng = np.random.RandomState(8)
    images = np.stack([_images(8, 64, seed=20 + i) for i in range(2)])
    labels = rng.randint(0, N_CLASSES, (2, 8)).astype(np.int32)
    np.savez(tmp_path / "data.npz", images=images, labels=labels)
    (tmp_path / "spec.json").write_text(json.dumps({
        "name": name, "cfg": BACKBONES["rn"][1], "feature_dim": FEATURE_DIM, "classes": N_CLASSES, "lr": 1e-3,
        "weights": str(tmp_path / "w.pt"), "data": str(tmp_path / "data.npz"), "out": str(tmp_path)}))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CODE, str(tmp_path / "spec.json")], cwd=REPO,
                              env=dict(env, RANK=str(r)), stdout=open(tmp_path / f"rank{r}.log", "w"),
                              stderr=subprocess.STDOUT) for r in range(2)]

    jstep, tx = jax_learner.make_classifier_train_step(jm, create_mesh(jax.devices()[:2]), steps_per_epoch=1,
                                                       precision="fp32")
    p, s = jax.device_put((params, state))
    opt = tx.init(p)
    want_metrics = []
    for i in range(2):
        p, s, opt, m = jstep(p, s, opt, {"images": images[i], "labels": labels[i]})
        want_metrics.append([float(m["loss"]), float(m["accuracy"])])
    for r, proc in enumerate(procs):
        assert proc.wait(timeout=240) == 0, (tmp_path / f"rank{r}.log").read_text()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(2)]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for v0, v1 in zip(ranks[0]["state"].values(), ranks[1]["state"].values()):
        assert torch.equal(v0, v1)
    np.testing.assert_allclose(ranks[0]["metrics"][0][0], want_metrics[0][0], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["metrics"][1][0], want_metrics[1][0], rtol=1e-3)
    assert [m[1] for m in ranks[0]["metrics"]] == [m[1] for m in want_metrics]
    want = port_ckpt.classifier_state_dict_from_pytrees(jax.device_get(p), jax.device_get(s), model.clip_cfg)
    for k, v in ranks[0]["state"].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 2, k
            continue
        err = float((v - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-3)
        assert err < (1e-4 if "running" in k else 3e-3), (k, err)


def test_sgd_matches_optax_on_equal_gradients(monkeypatch):
    """``optim.sgd_nesterov`` + ``schedule.piecewise_constant`` against the
    JAX classifier's optimizer (``add_decayed_weights(1e-4, wd_mask)`` then
    Nesterov ``sgd`` at the piecewise schedule) on the tiny ViT's weights
    and the same seeded gradients for 4 steps across a boundary: every
    parameter within 1e-6 of its scale."""
    import optax

    _register(monkeypatch, "vit")
    model, _, params, state = _models(lr=0.1, milestones=(2,))
    bounds = {2: 0.1}
    tx = optax.chain(optax.add_decayed_weights(1e-4, mask=jax_optim.wd_mask),
                     optax.sgd(learning_rate=optax.piecewise_constant_schedule(0.1, bounds), momentum=0.9,
                               nesterov=True))
    opt = tx.init(params)
    optimizer = optim.sgd_nesterov(model, lr=0.1, momentum=0.9, weight_decay=1e-4)
    sched = schedule.piecewise_constant(0.1, bounds)
    gen = torch.Generator().manual_seed(7)
    for i in range(4):
        grads = {n: torch.randn(p.shape, generator=gen) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        for group in optimizer.param_groups:
            group["lr"] = sched(i)
        optimizer.step()
        jgrads, _ = classifier_pytrees_from_state_dict({**model.state_dict(), **grads}, model.clip_cfg)
        updates, opt = tx.update(jgrads, opt, params)
        params = optax.apply_updates(params, updates)
    want = port_ckpt.classifier_state_dict_from_pytrees(jax.device_get(params), state, model.clip_cfg)
    for n, p in model.named_parameters():
        assert float((p.detach() - want[n]).abs().max()) <= 1e-6 * max(float(want[n].abs().max()), 1.0), n


def test_lr_schedule_matches_optax():
    """The per-step rate at steps b-1, b and b+1 of each boundary equals
    optax's ``piecewise_constant_schedule`` bit for bit (the boundary's scale
    applies from step b on: not a per-epoch MultiStepLR)."""
    import optax

    spe, lr, milestones = 7, 0.1, (30, 50, 70)
    bounds = {m * spe: 0.1 for m in milestones}
    want = optax.piecewise_constant_schedule(lr, bounds)
    got = schedule.piecewise_constant(lr, bounds)
    for b in bounds:
        for i in (0, b - 1, b, b + 1):
            assert got(i) == float(want(i)), i
    assert got(30 * spe - 1) == float(np.float32(0.1)) and got(30 * spe) < got(30 * spe - 1)


@pytest.mark.parametrize("kind", ["rn", "vit"])
def test_decayed_tensors_match_wd_mask(kind, monkeypatch):
    """``optim.decays`` on the port's names selects the tensors JAX's
    ``wd_mask`` selects on its pytree paths: each parameter is filled with
    its own index, carried through the bridge, and every JAX leaf's mask
    must equal the rule of the port parameters it came from (the head's
    weight decayed, its bias not)."""
    _register(monkeypatch, kind)
    model = learner.create_classifier(learner.ClassifierCfg(num_classes=N_CLASSES), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    sd = dict(model.state_dict())
    for i, (n, prm) in enumerate(model.named_parameters()):
        sd[n] = torch.full_like(prm, float(i + 1))
    params, _ = classifier_pytrees_from_state_dict(sd, model.clip_cfg)
    mask = jax_flatten_pytree(jax_optim.wd_mask(params))
    leaves = port_ckpt.flatten_pytree(params)
    port_rule = {n: optim.decays(n, p) for n, p in model.named_parameters()}
    seen = set()
    for path, leaf in leaves.items():
        sources = {names[int(v) - 1] for v in np.unique(leaf)}
        seen |= sources
        assert all(port_rule[n] == bool(mask[path]) for n in sources), (path, sources)
    assert seen == set(names)
    assert port_rule["head.weight"] and not port_rule["head.bias"]


@pytest.mark.parametrize("kind", ["rn", "vit"])
def test_npz_round_trips_both_ways(kind, monkeypatch, tmp_path):
    """JAX ``save_classifier`` -> port ``load_classifier`` and port
    ``save_classifier`` -> JAX ``load_classifier`` give the same logits; both
    files hold the same keys and the extras."""
    _register(monkeypatch, kind)
    _shape_init(monkeypatch)
    model, jm, params, state = _models(seed=4)
    x = _images(3, model.image_size, seed=5)
    apply = jax.jit(lambda p, s, x: jm.apply(p, s, x)[0])
    want = np.asarray(apply(params, state, x))

    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_learner.save_classifier(jax_path, jm, params, state, {"epoch": 3})
    other = learner.create_classifier(learner.ClassifierCfg(num_classes=N_CLASSES), device="cpu", seed=9)
    assert learner.load_classifier(jax_path, other) == {"epoch": 3}
    with torch.no_grad():
        np.testing.assert_allclose(other(torch.from_numpy(x)).numpy(), want, atol=ATOL, rtol=ATOL)

    learner.save_classifier(port_path, model, {"epoch": 5})
    p2, s2, extras = jax_learner.load_classifier(port_path, jm)
    assert extras == {"epoch": 5}
    np.testing.assert_allclose(np.asarray(apply(p2, s2, x)), want, atol=ATOL, rtol=ATOL)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape for k in a.files if k != "__extras__")


def test_load_classifier_refuses_a_missing_key(monkeypatch, tmp_path):
    _register(monkeypatch, "rn")
    model, _, params, state = _models()
    del params["head"]["bias"]
    port_ckpt.save_native(str(tmp_path / "bad.npz"), params, state)
    with pytest.raises(KeyError, match="missing key head/bias"):
        learner.load_classifier(str(tmp_path / "bad.npz"), model)


class _Images:
    """10 seeded float images with labels, for the predictions."""

    def __init__(self, size):
        self.size = size

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return _images(1, self.size, seed=100 + i)[0], i % N_CLASSES


def test_classifier_predictions_match_jax(monkeypatch):
    """Batches of 4 over 10 images (a ragged last batch, unpadded in the
    port, zero-padded in JAX) with ``logit_slice=(2, 7)``: equal labels and
    predictions."""
    _register(monkeypatch, "rn")
    model, jm, params, state = _models(seed=6)
    got = learner.classifier_predictions(model, _Images(64), batch_size=4, num_threads=2, logit_slice=(2, 7))
    want = jax_learner.classifier_predictions(jm, params, state, _Images(64), batch_size=4, num_threads=2,
                                              logit_slice=(2, 7))
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["pred"], want["pred"])
    assert got["pred"].max() < 5


def _load_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, SCRIPTS)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(SCRIPTS)
    return mod


def _lso_classnames():
    from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX

    names = [f"thing {i}" for i in range(345)]
    for cls, idx in LSO_CLASS_TO_IDX.items():
        names[idx] = cls
    return names


def test_supervised_evaluator_matches_jax(monkeypatch, tmp_path):
    """``evaluate_domainnet_supervised_lso`` over three JAX-written
    checkpoints (given out of order) on a DomainNet tree of 345 classes x
    (sketch, real): the port's ``results.json`` equals the JAX script's."""
    import argparse

    _register(monkeypatch, "rn")
    _shape_init(monkeypatch)
    rng = np.random.RandomState(0)
    dn = tmp_path / "domainnet"
    for domain in ("real", "sketch"):
        rows = []
        for ci, cls in enumerate(_lso_classnames()):
            path = dn / domain / cls.replace(" ", "_") / "0.jpg"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.randint(0, 255, (24, 24, 3), np.uint8)).save(path)
            rows.append(f"{domain}/{cls.replace(' ', '_')}/0.jpg\t{ci}\ta photo.")
        (dn / f"{domain}_test.tsv").write_text("\n".join(rows) + "\n")
    ckpts = []
    for epoch in (2, 0, 1):
        _, jm, params, state = _models(seed=epoch, num_classes=1345)
        ckpts.append(str(tmp_path / ("epoch=0-step=0.npz" if epoch == 0 else f"epoch={epoch}.npz")))
        jax_learner.save_classifier(ckpts[-1], jm, params, state, {"epoch": epoch})
    jax_script = _load_script("evaluate_domainnet_supervised_lso")
    jax_script.main(argparse.Namespace(model="rn50-clip", domain="sketch", ckpt_files=ckpts,
                                       out_path=str(tmp_path / "jax"), domainnet_path=str(dn), num_workers=2))
    assert port_sup_eval.main(["--model", "rn50-clip", "--domain", "sketch", "--ckpt_files", *ckpts,
                               "--out_path", str(tmp_path / "port"), "--domainnet_path", str(dn),
                               "--num_workers", "2", "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "jax" / "results.json").read_text())
    got = json.loads((tmp_path / "port" / "results.json").read_text())
    assert got["steps"] == want["steps"] == [0, 1, 2]
    assert got == want


def _combined_tree(tmp_path, n=8):
    """A CombinedNet tree: an ImageNet wnid folder, a wnid that the mapping
    folds into a DomainNet class, and a DomainNet class folder; train and
    val TSVs of n images each per folder."""
    with open(os.path.join(REPO, "data", "imagenet_class_index.json")) as fh:
        index = json.load(fh)
    with open(os.path.join(REPO, "data", "in_to_dn_mapping.json")) as fh:
        mapping = json.load(fh)
    folded = next(i for v in mapping.values() if v for i in v)
    parents = [index["0"][0], index[str(folded)][0], "traffic_light"]
    rng = np.random.RandomState(0)
    for split in ("train", "val"):
        rows = []
        for parent in parents:
            for j in range(n):
                p = tmp_path / "imgs" / split / parent / f"{j}.jpg"
                p.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(rng.randint(0, 255, (72, 80, 3), np.uint8)).save(p)
                rows.append(f"{p}\ta photo.\n")
        (tmp_path / f"{split}.tsv").write_text("filepath\ttitle\n" + "".join(rows))
    return [str(tmp_path / f"{s}.tsv") for s in ("train", "val")]


def _cli_argv(tmp_path, train_tsv, val_tsv, ws, epochs=2):
    return ["--model", "rn50-clip", "--train_index_path", train_tsv, "--val_index_path", val_tsv,
            "--in_class_index_path", os.path.join(REPO, "data", "imagenet_class_index.json"),
            "--class_mapping_path", os.path.join(REPO, "data", "in_to_dn_mapping.json"),
            "--experiment_name", "smoke", "--learning_rate", "0.01", "--batch_size", "8", "--num_workers", "2",
            "--max_epochs", str(epochs), "--save_epochs", "1", "--seed", "0", "--ws_path", str(ws),
            "--precision", "32"]


def test_train_combined_captions_cli_writes_jax_files(monkeypatch, tmp_path, capsys):
    """``train_combined_captions.main`` with ``--device cpu`` for 2 epochs on
    a tiny CombinedNet tree writes the files of the JAX script's run (which
    starts from the port's weights): same names, same keys, same extras;
    logs a line every 50 steps with img/s and the validation; a resume from
    ``epoch=2.npz`` restarts the optimizer and writes ``epoch=0-step=0.npz``
    again with the resumed weights."""
    import argparse

    _register(monkeypatch, "rn")
    train_tsv, val_tsv = _combined_tree(tmp_path)
    _, _, params, state = _models(num_classes=1345)
    monkeypatch.setattr(jax_learner.Classifier, "init", lambda self, rng: (params, state))
    jax_script = _load_script("train_combined_captions")
    args = port_train_cli.parse_args(_cli_argv(tmp_path, train_tsv, val_tsv, tmp_path / "jax") + ["--device", "cpu"])
    jax_script.train(argparse.Namespace(**{k: v for k, v in vars(args).items() if k != "device"}))
    capsys.readouterr()
    assert port_train_cli.main(_cli_argv(tmp_path, train_tsv, val_tsv, tmp_path / "port") + ["--device", "cpu"]) == 0
    jdir, pdir = tmp_path / "jax" / "checkpoints" / "smoke", tmp_path / "port" / "checkpoints" / "smoke"
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir)) == ["epoch=0-step=0.npz", "epoch=1.npz", "epoch=2.npz", "last.npz"]
    for name in names:
        a, b = port_ckpt.load_native(str(jdir / name)), port_ckpt.load_native(str(pdir / name))
        assert set(a[0]) == set(b[0]) and set(a[1]) == set(b[1]) and a[2] == b[2]
    lines = [ln.split(" | INFO | ")[-1] for ln in capsys.readouterr().out.splitlines()]
    assert any(ln.startswith("epoch 0 step 0 loss ") and ln.endswith("img/s)") for ln in lines), lines
    assert any(ln.startswith("epoch 2 done: val_loss ") for ln in lines), lines

    # resume: the weights of epoch=2.npz, the optimizer and schedule from step 0
    first = dict(np.load(pdir / "epoch=2.npz"))
    assert port_train_cli.main(_cli_argv(tmp_path, train_tsv, val_tsv, tmp_path / "port", epochs=3)
                               + ["--ckpt_path", str(pdir / "epoch=2.npz"), "--device", "cpu"]) == 0
    again = dict(np.load(pdir / "epoch=0-step=0.npz"))
    assert all(np.array_equal(first[k], again[k]) for k in first if k != "__extras__")
    assert port_ckpt.load_native(str(pdir / "epoch=3.npz"))[2] == {"epoch": 3}


def test_cli_defaults_to_cuda(tmp_path):
    args = port_train_cli.parse_args(["--train_index_path", "t", "--val_index_path", "v", "--in_class_index_path",
                                      "i", "--class_mapping_path", "m", "--experiment_name", "e"])
    assert (args.device, args.precision, args.batch_size, args.learning_rate) == ("cuda", "16-mixed", 256, 0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_train_cli.main(["--train_index_path", "t", "--val_index_path", "v", "--in_class_index_path", "i",
                                 "--class_mapping_path", "m", "--experiment_name", "e"])


def _launcher_argv(tmp_path, launcher: str, env: dict):
    """The command a launcher runs, read from a ``python`` stub on PATH."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    out = tmp_path / "argv.txt"
    stub = bin_dir / "python"
    stub.write_text(f'#!/bin/bash\nprintf "%s\\n" "$@" > "{out}"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    subprocess.run(["bash", os.path.join(REPO, "launchers", launcher)], cwd=tmp_path, check=True,
                   env=dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", **env), capture_output=True,
                   timeout=60)
    return out.read_text().splitlines()


def test_supervised_launchers_parse(tmp_path):
    """``launchers/train-supervised.sh`` and ``evaluate-supervised.sh``
    expanded with their defaults: the commands after the script path parse
    in the port's CLIs with the launchers' values."""
    argv = _launcher_argv(tmp_path, "train-supervised.sh", {"DATAID": "lso-cipqrs-nosketchclasses"})
    assert argv[0] == "scripts/train_combined_captions.py"
    args = port_train_cli.parse_args(argv[1:])
    assert (args.model, args.batch_size, args.max_epochs, args.learning_rate) == ("rn50-clip", 256, 90, 0.1)
    assert args.experiment_name == "supervised-lso-cipqrs-nosketchclasses-lr0.1"
    assert args.train_index_path == "data/indices/combined-captions-train-lso-cipqrs-nosketchclasses.tsv"

    ckpt_dir = tmp_path / "ckpts"
    ckpt_dir.mkdir()
    for name in ("epoch=0-step=0.npz", "epoch=5.npz", "last.npz"):
        (ckpt_dir / name).write_bytes(b"")
    argv = _launcher_argv(tmp_path, "evaluate-supervised.sh",
                          {"CKPT_DIR": str(ckpt_dir), "DOMAIN": "sketch", "DOMAINNET": "dn"})
    assert argv[0] == "scripts/evaluate_domainnet_supervised_lso.py"
    args = port_sup_eval.parse_args(argv[1:])
    assert (args.model, args.domain, args.domainnet_path, args.device) == ("rn50-clip", "sketch", "dn", "cuda")
    assert [os.path.basename(f) for f in args.ckpt_files] == ["epoch=0-step=0.npz", "epoch=5.npz"]
    assert args.out_path == f"{ckpt_dir}/lso-eval-sketch"
    assert [port_sup_eval.epoch_from_file(f) for f in args.ckpt_files] == [0, 5]


# the committed goldens the port builds: RN50 and ViT-B-32; the timm
# families' smallest members (EVA02, ConvNeXt, the gap and relpos medium
# ViTs, a SigLIP CLIP with its text tower); the ResNet and ViT variants
# (RN101, RN50x4, ViT-B-16, quick_gelu, LayerScale). The three whose JAX
# init costs most on the CPU run under ``slow``.
GOLDEN_NAMES = ["RN50", "ViT-B-32", "EVA02-B-16", "convnext_tiny", "vit_medium_patch16_gap_256",
                "vit_relpos_medium_patch16_cls_224", "ViT-B-16-SigLIP", "RN101", "RN50x4", "ViT-B-16",
                "ViT-B-32-quickgelu", "ViT-M-16-alt"] + [
    pytest.param(name, marks=pytest.mark.slow) for name in ("ViT-SO400M-14-SigLIP", "convnext_large_d",
                                                            "ViT-L-14-CLIPA")]


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_full_width_tower_matches_golden(name):
    """A committed golden config at full width: JAX's seeded init
    (``create_model(name, pretrained_hf=False)``, as the golden test
    builds it) carried into the port, on the golden test's 2 seeded images
    and texts on the CPU, against ``tests/goldens/<name>.npz`` at the golden
    test's tolerance (rtol 2e-3, atol 2e-4; the port's fp32 differs from
    the XLA run that wrote the goldens by summation order only)."""
    from test_golden_regression import GOLDEN_DIR, _seeded_batch
    from xclip_tpu.models.factory import create_model

    jm, params, state = create_model(name, pretrained_hf=False)
    images, texts = _seeded_batch(name, jm)
    port = factory.create_model(name, device="cpu")
    port.load_state_dict(state_dict_from_jax_params(jax.device_get(params), jax.device_get(state), port.cfg),
                         strict=True)
    del params, state
    golden = dict(np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")))
    with torch.no_grad():
        got = {"image_features": port.encode_image(torch.from_numpy(images), normalize=True).numpy(),
               "text_features": port.encode_text(torch.from_numpy(texts), normalize=True).numpy()}
    assert set(got) == set(golden)
    for key, ref in golden.items():
        np.testing.assert_allclose(got[key], ref, rtol=2e-3, atol=2e-4, err_msg=f"{name}:{key}")
