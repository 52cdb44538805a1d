"""The port's training slice against the JAX package's on the CPU.

- The train step: a tiny RN CLIP (ResNet layers (1,1,1,1), width 16, 64 px;
  text width 32, 2 layers), its JAX weights carried into the port, three
  steps on the same seeded uint8 batches at ``precision="fp32"``, against
  ``make_train_step`` on a one-device mesh with the Pallas bottleneck
  (``XCLIP_PALLAS_BLOCK=1``, interpret mode): loss, grad norm and logit
  scale per step, the (clipped) grads of the first step, and the
  parameters and BatchNorm running statistics after the third; at
  accum-freq 1 and 2, with and without grad checkpointing.
- The pieces: wd mask, schedules, clip loss, on-device normalization, the
  train transform, loader order, the asset copies.
- The CLI: a tiny ``train.main`` run with ``--device cpu`` on synthetic data
  and on a TSV, with ``--resume latest``; its ``.pt`` loads in the JAX
  package's ``create_model(pretrained=...)`` with the same features; the
  headline launcher's command parses; ``--report-to tensorboard`` writes
  JAX's six train tags, ``--report-to wandb`` the offline metric stream.

Everything is fp32 on the CPU, so tolerances cover summation order only;
each states its own.
"""

import filecmp
import json
import os
import random
import stat
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from test_torch_models import _randomize_bn, release_memory_after_module  # noqa: F401
from xclip_tpu.data.loader import DataLoader as JaxDataLoader
from xclip_tpu.data.transforms import image_transform as jax_image_transform
from xclip_tpu.data.transforms import random_resized_crop as jax_random_resized_crop
from xclip_tpu.models import factory as jax_factory
from xclip_tpu.models.clip import CLIPModel
from xclip_tpu.parallel.mesh import create_mesh
from xclip_tpu.tokenizer import tokenize as jax_tokenize
from xclip_tpu.train import loss as jax_loss
from xclip_tpu.train import optim as jax_optim
from xclip_tpu.train import schedule as jax_schedule
from xclip_tpu.train import step as jax_step
from xclip_tpu_torch import _assets
from xclip_tpu_torch.core.checkpoint import state_dict_from_jax_params
from xclip_tpu_torch.data.loader import DataLoader
from xclip_tpu_torch.data.transforms import image_transform, random_resized_crop
from xclip_tpu_torch.models import factory
from xclip_tpu_torch.models.clip import CLIP, clip_cfg_from_dict
from xclip_tpu_torch.ops import flash_attention, fused_conv
from xclip_tpu_torch.train import loss, optim, schedule
from xclip_tpu_torch.train.step import TrainStepCfg, make_train_step, normalize_images

TINY_TRAIN = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 64, "layers": [1, 1, 1, 1], "width": 16, "patch_size": None},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 32, "heads": 2, "layers": 2},
}
MICRO = 8  # images per microbatch: a step takes MICRO * accum
STEPS = 3
LR, WARMUP, CLIP_NORM = 1e-5, 2, 1.0
# AdamW's eps for the parity runs. With the default 1e-6, the first update
# is about lr * sign(g), so an element whose gradient is within fp32
# summation noise of 0 moves by +-lr depending on that noise; eps 1e-3 keeps
# the update a smooth function of the gradient, so the comparison measures
# the port, not that amplification.
EPS = 1e-3
GRAD_TOL = 5e-4
CAPTIONS = ["a photo of a cat.", "a sketch of a barn.", "a painting of a lion.", "a clipart of a pizza.",
            "a quickdraw of a tractor.", "an infograph of a map.", "a real photo of a dog.", "a drawing."]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch in these tests. The test suite runs
    several workers on a shared CPU; there torch's thread pool waits on
    preempted threads at every op (one CLI test took 2 s alone and 70 s
    beside seven busy processes). The numbers do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(STEPS):
        images = rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)
        texts = jax_tokenize([CAPTIONS[i % len(CAPTIONS)] + f" {j}" for j, i in enumerate(rng.permutation(n))])
        out.append((images, texts))
    return out


@pytest.fixture(scope="module")
def jax_init():
    model = CLIPModel(jax_factory.clip_cfg_from_dict(TINY_TRAIN))
    params, state = jax.device_get(model.init(jax.random.PRNGKey(0)))
    _randomize_bn(params["visual"], state["visual"], np.random.RandomState(3))
    return model, params, state


def _keep_grads() -> optax.GradientTransformation:
    """Passes updates through unchanged and keeps them in its state, so the
    optimizer state shows the (clipped) gradient of the last step."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}))


def _jax_run(jax_init, accum, ckpt):
    """Three JAX train steps: per-step metrics, the first step's clipped
    grads, and the parameters and state after the third. The optimizer is
    ``optim.adamw``'s chain (clip, then AdamW with the wd mask) with a
    pass-through transform between the two that records the gradient."""
    model, params, state = jax_init
    cfg = jax_step.TrainStepCfg(precision="fp32", accum_freq=accum, grad_checkpointing=ckpt)
    tx = optax.chain(optax.clip_by_global_norm(CLIP_NORM), _keep_grads(),
                     jax_optim.adamw(jax_schedule.cosine_lr(LR, WARMUP, STEPS), beta1=0.9, beta2=0.98,
                                     eps=EPS, weight_decay=0.2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XCLIP_PALLAS_BLOCK", "1")
        step = jax_step.make_train_step(model, tx, create_mesh(jax.devices()[:1]), cfg)
        p, s = jax.device_put((params, state))
        opt = tx.init(p)
        metrics, grads = [], None
        for images, texts in _batches(MICRO * accum):
            p, s, opt, m = step(p, s, opt, {"images": images, "texts": texts})
            metrics.append({k: float(v) for k, v in m.items()})
            grads = jax.device_get(opt[1]["g"]) if grads is None else grads
    return grads, jax.device_get(p), jax.device_get(s), metrics


def _port_model(params, state):
    cfg = clip_cfg_from_dict(TINY_TRAIN)
    with torch.device("meta"):
        model = CLIP(cfg)
    model = model.to_empty(device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, state, cfg), strict=True)
    return model.train()


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(jax_init, accum):
    """Three steps of the port (8 images per microbatch), without and with
    grad checkpointing, against three JAX steps (JAX recomputes per block at accum 2, the paper's
    setting, and not at accum 1; recomputation changes no number).

    Step 1, where both start from the same weights: loss, grad norm and
    logit scale rtol 1e-5; each clipped gradient tensor within GRAD_TOL =
    5e-4 of its largest element (measured: 5e-5; fp32 summation order
    through up to 15 train-mode BatchNorms. Batches of 8 per microbatch
    keep this model well conditioned: at 16 images in one batch the JAX
    package's own XLA and Pallas bottlenecks differ by 1.5 % on a layer-2
    gradient, and the port by the same order). Steps 2-3 start from weights that already differ in
    the last bits, and this tiny model's grad norm moves by 6.5e-5
    (relative) under 1e-7 relative weight noise, so there the metrics are
    held to rtol 1e-3. After step 3: parameters atol 5e-6 (each step moves a
    weight by up to lr = 1e-5), BatchNorm running statistics atol 2e-6, and
    ``num_batches_tracked`` shows one update per microbatch."""
    _, params, state = jax_init
    want_grads, want_params, want_state, want_metrics = _jax_run(jax_init, accum, ckpt=accum == 2)
    cfg = clip_cfg_from_dict(TINY_TRAIN)
    g_sd = state_dict_from_jax_params(want_grads, state, cfg)
    want_sd = state_dict_from_jax_params(want_params, want_state, cfg)
    for ckpt in (False, True):
        model = _port_model(params, state)
        opt = optim.adamw(model, lr=LR, beta1=0.9, beta2=0.98, eps=EPS, weight_decay=0.2)
        step = make_train_step(model, opt, schedule.cosine_lr(LR, WARMUP, STEPS),
                               TrainStepCfg(precision="fp32", grad_checkpointing=ckpt, accum_freq=accum,
                                            grad_clip_norm=CLIP_NORM))
        before = (fused_conv.stats_launches, fused_conv.stats_backward_calls, flash_attention.backward_calls)
        for i, (images, texts) in enumerate(_batches(MICRO * accum)):
            m = step(torch.from_numpy(images), torch.from_numpy(texts), i)
            for key in ("loss", "grad_norm", "logit_scale"):
                rtol = 1e-5 if i == 0 or key == "logit_scale" else 1e-3
                np.testing.assert_allclose(float(m[key]), want_metrics[i][key], rtol=rtol,
                                           err_msg=f"ckpt={ckpt} step {i} {key}")
            if i == 0:
                for name, p in model.named_parameters():
                    want = g_sd[name].numpy()
                    np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, err_msg=name,
                                               atol=max(GRAD_TOL * float(np.abs(want).max()), 1e-7))
        assert fused_conv.stats_launches == before[0]  # the CPU runs the plain version, no kernel
        assert fused_conv.stats_backward_calls > before[1] and flash_attention.backward_calls > before[2]
        for name, val in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                assert int(val) == STEPS * accum, name
                continue
            atol = 2e-6 if "running" in name else 5e-6
            np.testing.assert_allclose(val.numpy(), want_sd[name].numpy(), atol=atol, rtol=0,
                                       err_msg=f"ckpt={ckpt} {name}")


def test_adamw_and_clip_match_optax(jax_init):
    """The optimizer alone: the port's clip + two-group AdamW + schedule and
    the JAX ``optim.adamw`` chain (optax) on the same gradients for 4 steps,
    with one step under the clip norm and three above it, at the default
    eps 1e-6 and lr 1e-3. fp32 on both: atol 1e-6 on weights of O(0.1)."""
    _, params, state = jax_init
    cfg = clip_cfg_from_dict(TINY_TRAIN)
    model = _port_model(params, state)
    rng = np.random.RandomState(4)
    grads = [jax.tree_util.tree_map(lambda a: np.asarray(rng.randn(*np.shape(a)) * scale, np.float32), params)
             for scale in (1e-4, 1e-2, 3e-2, 1e-2)]
    sched = jax_schedule.cosine_lr(1e-3, 2, 4)
    tx = jax_optim.adamw(sched, beta1=0.9, beta2=0.98, eps=1e-6, weight_decay=0.2, grad_clip_norm=1.0)
    p, opt_state = params, tx.init(params)
    opt = optim.adamw(model, lr=1e-3, beta1=0.9, beta2=0.98, eps=1e-6, weight_decay=0.2)
    port_sched = schedule.cosine_lr(1e-3, 2, 4)
    names = [n for n, _ in model.named_parameters()]
    for i, g in enumerate(grads):
        updates, opt_state = jax.jit(tx.update)(g, opt_state, p)
        p = optax.apply_updates(p, updates)
        g_sd = state_dict_from_jax_params(g, state, cfg)
        for name, param in model.named_parameters():
            param.grad = g_sd[name].clone().reshape(param.shape)
        gs = [param.grad for param in model.parameters()]
        norm = optim.global_norm(gs)
        assert (float(norm) < 1.0) == (i == 0)
        optim.clip_by_global_norm_(gs, norm, 1.0)
        for group in opt.param_groups:
            group["lr"] = port_sched(i)
        opt.step()
    want = state_dict_from_jax_params(jax.device_get(p), state, cfg)
    for name, param in zip(names, model.parameters()):
        np.testing.assert_allclose(param.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_wd_mask_matches_jax(jax_init):
    """The decay rule on every parameter, mapped to open_clip names: each
    JAX leaf's mask value, spread over its shape, goes through the same
    name mapping as the weights (q/k/v concatenate into in_proj)."""
    _, params, state = jax_init
    mask = jax_optim.wd_mask(params)
    as_arrays = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
    want = state_dict_from_jax_params(as_arrays, state, clip_cfg_from_dict(TINY_TRAIN))
    model = _port_model(params, state)
    got = optim.wd_mask(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    for name, decays in got.items():
        vals = np.unique(want[name].numpy())
        assert vals.tolist() == [float(decays)], name
    assert sum(got.values()) > 0 and not all(got.values())
    groups = optim.adamw(model, lr=1e-3).param_groups
    assert [g["weight_decay"] for g in groups] == [0.0, 0.2]
    assert sum(len(g["params"]) for g in groups) == len(got)


@pytest.mark.parametrize("name,kw", [("cosine", {}), ("const", {}),
                                     ("const-cooldown", {"cooldown_steps": 30, "cooldown_power": 2.0,
                                                         "cooldown_end_lr": 1e-5})])
def test_schedules_match_jax(name, kw):
    """Warmup 10, 100 steps: the port (float64) against the JAX schedules
    (float32): rtol 1e-6, atol 1e-10 (fp32 rounding of lr values near 0 at
    the end of the cosine)."""
    steps = [0, 1, 5, 9, 10, 11, 50, 69, 70, 71, 98, 99, 120]
    want = jax_schedule.get_scheduler(name, 5e-4, 10, 100, **kw)
    got = schedule.get_scheduler(name, 5e-4, 10, 100, **kw)
    np.testing.assert_allclose([got(s) for s in steps], [float(want(s)) for s in steps], rtol=1e-6, atol=1e-10)


def test_clip_loss_and_normalize_match_jax():
    """clip_loss (atol 1e-6) and the on-device uint8 normalization (atol
    1e-6) against the JAX functions on the same inputs."""
    rng = np.random.RandomState(0)
    img, txt = rng.randn(6, 16).astype(np.float32), rng.randn(6, 16).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    want = jax_loss.clip_loss(jnp.asarray(img), jnp.asarray(txt), jnp.float32(14.3))
    got = loss.clip_loss(torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(14.3))
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)
    images = rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    np.testing.assert_allclose(normalize_images(torch.from_numpy(images)).numpy(),
                               np.asarray(jax_step.normalize_images(jnp.asarray(images), jax_step.TrainStepCfg())),
                               atol=1e-6)
    floats = torch.randn(2, 8, 8, 3)
    assert normalize_images(floats) is floats


@pytest.mark.parametrize("size", [(256, 256), (300, 200), (90, 400)])
def test_train_transform_byte_identical(size):
    """random_resized_crop and the uint8 train transform against the JAX
    ones at an equal random.Random seed: the same bytes, several draws."""
    img = Image.fromarray(np.random.RandomState(size[0]).randint(0, 256, (size[1], size[0], 3), np.uint8))
    tf = image_transform(64, is_train=True, seed=size[1])
    jtf = jax_image_transform(64, is_train=True, seed=size[1], to_uint8=True)
    for _ in range(3):
        got, want = tf(img), jtf(img)
        assert got.dtype == np.uint8 and got.shape == (64, 64, 3) and got.tobytes() == want.tobytes()
    a = random_resized_crop(img, 32, scale=(0.08, 1.0), rng=random.Random(1))
    b = jax_random_resized_crop(img, 32, scale=(0.08, 1.0), rng=random.Random(1))
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("is_train,seed", [(False, None), (True, None), (True, 3)])
def test_transforms_pickle_for_worker_processes(is_train, seed):
    """The evaluator sends its transform to spawned DataLoader workers."""
    import pickle

    tf = image_transform(32, is_train=is_train, seed=seed)
    img = Image.fromarray(np.random.RandomState(0).randint(0, 256, (40, 50, 3), np.uint8))
    clone = pickle.loads(pickle.dumps(tf))
    if seed is not None or not is_train:
        assert clone(img).tobytes() == tf(img).tobytes()


class _IndexDataset:
    def __len__(self):
        return 37

    def __getitem__(self, i):
        return np.full((2,), i, np.int32), f"caption {i}"


@pytest.mark.parametrize("rank,world_size", [(0, 1), (1, 3)])
def test_loader_order_matches_jax(rank, world_size):
    """Batch contents over two epochs equal the JAX loader's at an equal
    seed, epoch and rank (threads do not reorder batches)."""
    kw = dict(shuffle=True, seed=7, drop_last=True, num_threads=4, rank=rank, world_size=world_size)
    port, ref = DataLoader(_IndexDataset(), 4, **kw), JaxDataLoader(_IndexDataset(), 4, **kw)
    assert port.num_batches == ref.num_batches and port.num_samples == ref.num_samples
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == port.num_batches
        for (gi, gc), (wi, wc) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert gc == wc


def test_loader_raises_a_sample_error():
    """An exception while decoding reaches the consumer instead of hanging it."""
    class Broken(_IndexDataset):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("truncated file")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="truncated"):
        list(DataLoader(Broken(), 4, num_threads=2))


def test_assets_are_byte_identical_copies():
    """The port reads its own copies of the JAX package's data files."""
    jax_pkg = _assets.REPO_ROOT / "xclip_tpu"
    pairs = [(_assets.BPE_VOCAB, jax_pkg / "tokenizer" / "bpe_simple_vocab_16e6.txt.gz"),
             (_assets.EVAL_METADATA, jax_pkg / "evals" / "metadata.json")]
    configs = sorted(_assets.MODEL_CONFIG_DIR.glob("*.json"))
    assert {p.name for p in configs} == {p.name for p in (jax_pkg / "models" / "configs").glob("*.json")}
    pairs += [(p, jax_pkg / "models" / "configs" / p.name) for p in configs]
    for mine, theirs in pairs:
        assert "xclip_tpu_torch" in mine.parts and filecmp.cmp(mine, theirs, shallow=False), mine.name


def _write_tsv(root, n=16):
    rng = np.random.RandomState(0)
    rows = ["filepath\ttitle"]
    for i in range(n):
        path = root / f"{i}.jpg"
        Image.fromarray(rng.randint(0, 256, (80, 96, 3), np.uint8)).save(path)
        rows.append(f"{path}\t{CAPTIONS[i % len(CAPTIONS)]}")
    tsv = root / "train.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    return tsv


@pytest.mark.parametrize("data", ["synthetic", "tsv"])
def test_main_cli_trains_resumes_and_loads_in_jax(tmp_path, monkeypatch, data):
    """``train.main`` on the CPU: 2 epochs of 2 steps (accum 2, grad
    checkpointing), then ``--resume latest`` to epoch 3. Every loss is finite
    and logged in the reference format; ``epoch_3.pt`` holds the epoch, the
    name and the optimizer state, and loads both into the port and into the
    JAX package's ``create_model(pretrained=...)``, which give the same
    features (fp32, atol 1e-4)."""
    from xclip_tpu_torch.core.checkpoint import load_training_checkpoint
    from xclip_tpu_torch.train import main as train_main

    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinyRNtrain", TINY_TRAIN)
    monkeypatch.setitem(jax_factory._MODEL_CONFIGS, "TinyRNtrain", TINY_TRAIN)
    if data == "tsv":
        data_args = ["--dataset-type", "tsv", "--train-data", str(_write_tsv(tmp_path))]
    else:
        data_args = ["--dataset-type", "synthetic", "--train-num-samples", "16"]
    common = ["--model", "TinyRNtrain", *data_args, "--batch-size", "4", "--accum-freq", "2",
              "--grad-checkpointing", "--precision", "fp32", "--warmup", "2", "--lr", "1e-3",
              "--logs", str(tmp_path / "logs"), "--name", "run", "--log-every-n-steps", "1",
              "--device", "cpu", "--workers", "2", "--seed", "0"]
    assert train_main.main(common + ["--epochs", "2", "--save-most-recent"]) == 0
    assert train_main.main(common + ["--epochs", "2"]) == -1  # the experiment exists
    assert train_main.main(common + ["--epochs", "3", "--resume", "latest"]) == 0
    ckpts = tmp_path / "logs" / "run" / "checkpoints"
    assert {p.name for p in ckpts.iterdir()} == {"epoch_1.pt", "epoch_2.pt", "epoch_3.pt", "epoch_latest.pt"}
    log = (tmp_path / "logs" / "run" / "out.log").read_text()
    lines = [ln for ln in log.splitlines() if "Train Epoch:" in ln]
    assert len(lines) == 6 and "=> resuming checkpoint" in log and "epoch_latest.pt' (epoch 2)" in log
    assert all("Batch (t):" in ln and "/s/gpu Scale:" in ln for ln in lines)
    losses = [float(ln.split("Loss: ")[1].split()[0]) for ln in lines]
    assert all(np.isfinite(losses))

    ckpt = torch.load(ckpts / "epoch_3.pt", map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 3 and ckpt["name"] == "run" and ckpt["optimizer"]["state"]
    port = factory.create_model("TinyRNtrain", device="cpu", seed=1)
    assert load_training_checkpoint(str(ckpts / "epoch_3.pt"), port) == {"epoch": 3, "name": "run"}
    jmodel, jparams, jstate = jax_factory.create_model("TinyRNtrain", pretrained=str(ckpts / "epoch_3.pt"))
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    ids = jax_tokenize(["a photo of a cat.", "a drawing."])
    want_img, _, _ = jmodel.encode_image(jparams, jnp.asarray(x), state=jstate, normalize=True)
    want_txt, _ = jmodel.encode_text(jparams, jnp.asarray(ids), normalize=True)
    with torch.inference_mode():
        got_img = port.encode_image(torch.from_numpy(x), normalize=True)
        got_txt = port.encode_text(torch.from_numpy(ids), normalize=True)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_txt.numpy(), np.asarray(want_txt), atol=1e-4, rtol=1e-4)


def test_main_cli_defaults_to_cuda():
    from xclip_tpu_torch.train import main as train_main
    from xclip_tpu_torch.train.params import parse_args

    args = parse_args([])
    assert args.device == "cuda" and args.precision == "amp" and args.beta2 == 0.98 and args.eps == 1e-6
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_main.main(["--dataset-type", "synthetic"])


def _launcher_argv(tmp_path, resume: bool):
    """The training command that ``launchers/train-clip.sh`` runs for task 5
    (RN50, seed 0), read from a ``python`` stub on PATH, after the
    interpreter's ``-u -m xclip_tpu.train.main``."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    out = tmp_path / "argv.txt"
    stub = bin_dir / "python"
    stub.write_text(f'#!/bin/bash\nprintf "%s\\n" "$@" > "{out}"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    if resume:
        ckpts = tmp_path / "logs" / "clip" / "RN50-lso-rs-nosketchclasses-s0" / "checkpoints"
        ckpts.mkdir(parents=True)
        (ckpts / "epoch_latest.pt").write_bytes(b"")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", TASK_ID="5")
    subprocess.run(["bash", os.path.join(root, "launchers", "train-clip.sh")], cwd=tmp_path, env=env,
                   check=True, capture_output=True, timeout=60)
    argv = out.read_text().splitlines()
    assert argv[:3] == ["-u", "-m", "xclip_tpu.train.main"]
    return argv[3:]


@pytest.mark.parametrize("resume", [False, True])
def test_launcher_command_parses(tmp_path, resume):
    """Every flag of the headline launcher's command (launchers/train-clip.sh,
    ``--report-to tensorboard`` and ``--resume latest`` included) goes
    through the port's ``parse_args`` with the values JAX's parser gives."""
    from xclip_tpu.train.params import parse_args as jax_parse_args
    from xclip_tpu_torch.train.params import parse_args

    argv = _launcher_argv(tmp_path, resume)
    args, want = parse_args(argv), jax_parse_args(argv)
    assert args.report_to == "tensorboard" and args.resume == ("latest" if resume else None)
    assert (args.batch_size, args.accum_freq, args.model, args.epochs) == (128, 2, "RN50", 32)
    for key, val in vars(args).items():
        if hasattr(want, key) and key != "device":
            assert getattr(want, key) == val, key
    assert (args.wandb_notes, args.wandb_project_name) == ("", "open-clip")


def _report_run(tmp_path, monkeypatch, report_to, extra=()):
    from xclip_tpu_torch.train import main as train_main

    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinyRNtrain", TINY_TRAIN)
    argv = ["--model", "TinyRNtrain", "--dataset-type", "synthetic", "--train-num-samples", "4",
            "--batch-size", "4", "--epochs", "1", "--precision", "fp32", "--warmup", "1",
            "--logs", str(tmp_path / "logs"), "--name", "run", "--log-every-n-steps", "1",
            "--device", "cpu", "--workers", "1", "--report-to", report_to, *extra]
    assert train_main.main(argv) == 0
    return tmp_path / "logs" / "run"


TRAIN_TAGS = ["train/loss", "train/logit_scale", "train/samples_per_second", "train/samples_per_second_per_gpu",
              "train/data_time", "train/batch_time"]


def test_report_to_tensorboard_writes_the_train_scalars(tmp_path, monkeypatch):
    """``--report-to tensorboard``: one step writes an event file under
    ``<logs>/<name>/tensorboard`` with JAX's six train tags at step 0, the
    loss the one the log line shows. TensorFlow is kept out of the import
    (tensorboard then uses its own stub; with TensorFlow the import takes
    ~20 s and 1 GB here)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader

    run = _report_run(tmp_path, monkeypatch, "tensorboard")
    (events,) = (run / "tensorboard").glob("events.out.tfevents.*")
    scalars = {}
    for event in EventFileLoader(str(events)).Load():
        for value in event.summary.value:
            scalars[value.tag] = (event.step, value.tensor.float_val[0] if value.HasField("tensor")
                                  else value.simple_value)
    assert sorted(scalars) == sorted(TRAIN_TAGS) and {step for step, _ in scalars.values()} == {0}
    logged = float((run / "out.log").read_text().split("Loss: ")[1].split()[0])
    assert scalars["train/loss"][1] == pytest.approx(logged, rel=1e-4)
    assert all(np.isfinite(v) for _, v in scalars.values()) and scalars["train/samples_per_second"][1] > 0


def test_report_to_wandb_writes_the_offline_stream(tmp_path, monkeypatch):
    """``--report-to wandb`` without the wandb package: the six train scalars
    at step 0, then the ``val/*`` metrics of ``--val-data`` at step 1 (one
    epoch of one step), in ``wandb-offline/history.jsonl``, with the run
    config and the summary."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    tsv = _write_tsv(tmp_path, n=4)
    run = _report_run(tmp_path, monkeypatch, "wandb", ["--val-data", str(tsv)])
    offline = run / "wandb-offline"
    rows = [json.loads(line) for line in (offline / "history.jsonl").read_text().splitlines()]
    assert [row["_step"] for row in rows] == [0, 1]
    assert sorted(k for k in rows[0] if k != "_step") == sorted(TRAIN_TAGS)
    assert {"val/clip_val_loss", "val/image_to_text_R@1", "val/epoch"} <= set(rows[1])
    assert json.loads((offline / "config.json").read_text())["report_to"] == "wandb"
    assert json.loads((offline / "summary.json").read_text())["_step"] == 1
