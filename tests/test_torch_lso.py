"""The port's zero-shot DomainNet-LSO slice end to end on the CPU, against
the JAX evaluator on the same checkpoint and the same synthetic data tree
(built as in tests/test_e2e_lso.py), plus the eval transform and the
dataset indexes it reads through.

The JAX model is initialised with seed 0 (BatchNorm statistics randomised
so the folded BatchNorm matters), saved as an open_clip ``.pt`` by the JAX
exporter, and evaluated by ``xclip_tpu.evals.run_lso.run_lso_evaluation``
and by the port's CLI ``main([... "--device", "cpu"])``. Sample counts must
match exactly; predictions must match except where JAX's own top-2 score
margin is below 1e-4 (fp32 summation order may swap such near ties).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax

import xclip_tpu.evals.run_lso as jax_run_lso
import xclip_tpu.models.factory as jax_factory
import xclip_tpu_torch.evals.run_lso as port_run_lso
from test_torch_models import TINY, _randomize_bn, release_memory_after_module  # noqa: F401
from xclip_tpu.core.checkpoint import save_open_clip_checkpoint
from xclip_tpu.data import datasets as jax_datasets
from xclip_tpu.data.transforms import image_transform as jax_image_transform
from xclip_tpu.evals.lso import LSO_CLASS_TO_IDX
from xclip_tpu.models.clip import CLIPModel
from xclip_tpu_torch.data import datasets as port_datasets
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.models import factory as port_factory

IMAGENET_CLASSES = ["cat", "dog", "fish"]
MARGIN = 1e-4


def _classnames():
    names = [f"thing {i}" for i in range(345)]
    for cls, idx in LSO_CLASS_TO_IDX.items():
        names[idx] = cls
    return names


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lso_tree")
    rng = np.random.RandomState(0)

    def save_img(path):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(path)

    for ci in range(3):
        for j in range(2):
            save_img(root / "imagenet" / "val" / f"n{ci:08d}" / f"im{j}.jpg")
    dn = root / "domainnet"
    for domain in ("real", "sketch"):
        rows = []
        for ci, cls in enumerate(_classnames()):
            cls_dir = cls.replace(" ", "_")
            save_img(dn / domain / cls_dir / "0.jpg")
            rows.append(f"{domain}/{cls_dir}/0.jpg\t{ci}\ta photo.")
        (dn / f"{domain}_test.tsv").write_text("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    model = CLIPModel(jax_factory.clip_cfg_from_dict(TINY))
    params, state = jax.device_get(model.init(jax.random.PRNGKey(0)))
    _randomize_bn(params["visual"], state["visual"], np.random.RandomState(1))
    path = tmp_path_factory.mktemp("ckpt") / "epoch_1.pt"
    save_open_clip_checkpoint(str(path), model, params, state, epoch=1)
    return path


def test_lso_slice_matches_jax(eval_tree, tiny_ckpt, tmp_path, monkeypatch):
    monkeypatch.setitem(jax_factory._MODEL_CONFIGS, "TinyRN", TINY)
    monkeypatch.setitem(port_factory._MODEL_CONFIGS, "TinyRN", TINY)
    monkeypatch.setattr(jax_run_lso, "XCLIP_IMAGENET_CLASSES", IMAGENET_CLASSES)
    monkeypatch.setattr(port_run_lso, "XCLIP_IMAGENET_CLASSES", IMAGENET_CLASSES)

    jax_scores = []

    class RecordingClassifier(jax_run_lso.OpenAIZeroShotClassifier):
        def predict_from_features(self, img_feat, return_scores=False):
            out = super().predict_from_features(img_feat, return_scores=return_scores)
            jax_scores.append(np.asarray(out["pred"]))
            return out

    monkeypatch.setattr(jax_run_lso, "OpenAIZeroShotClassifier", RecordingClassifier)

    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    want = jax_run_lso.run_lso_evaluation(
        "TinyRN", [str(tiny_ckpt)], str(jax_out), str(eval_tree / "imagenet"),
        str(eval_tree / "domainnet"), domain="sketch", domain_invariant=True, num_workers=2)
    assert port_run_lso.main([
        "--model", "TinyRN", "--domain", "sketch", "--ckpt_files", str(tiny_ckpt),
        "--out_path", str(port_out), "--imagenet_path", str(eval_tree / "imagenet"),
        "--domainnet_path", str(eval_tree / "domainnet"), "--num_workers", "0",
        "--domain_invariant", "--device", "cpu",
    ]) == 0
    got = json.loads((port_out / "results.json").read_text())

    assert set(got) == set(want)
    assert got["steps"] == want["steps"] == [1]
    assert got["domain"] == "sketch" and got["classes"] == want["classes"]
    assert got["domainnet-val"]["num-samples"] == want["domainnet-val"]["num-samples"]
    assert set(got["domainnet-val"]["accuracy"]) == set(want["domainnet-val"]["accuracy"])

    mismatched = 0
    for name, scores in (("val_pred", jax_scores[0]), ("domain_pred", jax_scores[1])):
        jp = np.load(jax_out / f"{name}.npy")[0]
        pp = np.load(port_out / f"{name}.npy")[0]
        top2 = np.sort(scores, axis=1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) < MARGIN
        assert np.all((jp == pp) | near_tie), f"{name}: predictions differ away from near ties"
        mismatched += int(np.sum(jp != pp))
    for name in ("val_labels", "domain_labels", "domain_ids"):
        np.testing.assert_array_equal(np.load(port_out / f"{name}.npy"), np.load(jax_out / f"{name}.npy"))
    if mismatched == 0:
        assert got["imagenet-val"] == want["imagenet-val"]
        assert got["domainnet-val"]["accuracy"] == want["domainnet-val"]["accuracy"]


def test_cli_defaults_to_cuda_and_refuses_without_it(eval_tree, tiny_ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_run_lso.main([
            "--model", "RN50", "--domain", "sketch", "--ckpt_files", str(tiny_ckpt),
            "--out_path", str(tmp_path), "--imagenet_path", str(eval_tree / "imagenet"),
            "--domainnet_path", str(eval_tree / "domainnet")])


@pytest.mark.parametrize("size", [(32, 32), (300, 200), (190, 640), (100, 100)])
@pytest.mark.parametrize("image_size", [32, 224])
def test_eval_transform_byte_identical(size, image_size):
    rng = np.random.RandomState(size[0] + image_size)
    img = Image.fromarray(rng.randint(0, 256, (size[1], size[0], 3), np.uint8))
    want = jax_image_transform(image_size, is_train=False)(img)
    got = image_transform(image_size, is_train=False)(img)
    assert got.dtype == want.dtype == np.float32 and got.shape == (image_size, image_size, 3)
    assert got.tobytes() == want.tobytes()


def test_eval_transform_grayscale_and_train_refused():
    img = Image.fromarray(np.random.RandomState(7).randint(0, 256, (50, 80), np.uint8), mode="L")
    assert image_transform(32)(img).tobytes() == jax_image_transform(32, is_train=False)(img).tobytes()
    # training is no longer refused: the uint8 train transform equals the
    # JAX one at an equal seed, grayscale input included
    got = image_transform(32, is_train=True, seed=3)(img)
    want = jax_image_transform(32, is_train=True, seed=3, to_uint8=True)(img)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()


def test_dataset_indexes_match_jax(eval_tree):
    tf = image_transform(32)
    jtf = jax_image_transform(32, is_train=False)
    got = port_datasets.ImageNet(str(eval_tree / "imagenet"), split="val", transform=tf)
    want = jax_datasets.ImageNet(str(eval_tree / "imagenet"), split="val", transform=jtf)
    assert got.samples == want.samples and got.classes == want.classes
    img, label = got[3]
    jimg, jlabel = want[3]
    assert label == jlabel and img.tobytes() == jimg.tobytes()
    exclude = ["clipart", "infograph", "painting", "quickdraw"]
    dn = port_datasets.DomainNetCaptions(str(eval_tree / "domainnet"), "val", tf, exclude_domains=exclude)
    jdn = jax_datasets.DomainNetCaptions(str(eval_tree / "domainnet"), "val", jtf, exclude_domains=exclude)
    assert dn.samples == jdn.samples
    img, label = dn[17]
    jimg, jlabel = jdn[17]
    assert label == jlabel and img.tobytes() == jimg.tobytes()
    assert port_datasets.DOMAIN_TO_IDX == jax_datasets.DOMAIN_TO_IDX


def test_lso_metrics_match_jax():
    """The metrics stage is a copy: identical dicts on random predictions."""
    from xclip_tpu.evals import lso as jax_lso
    from xclip_tpu_torch.evals import lso as port_lso

    rng = np.random.RandomState(0)
    classes = dict(enumerate(_classnames()))
    labels = np.concatenate([np.arange(345), np.arange(345)])
    ids = np.array([5] * 345 + [4] * 345)
    pred = np.where(rng.rand(690) < 0.5, labels, rng.randint(0, 345, 690))
    kw = dict(val_labels=labels[:20], val_pred=pred[:20], domain_labels=labels, domain_pred=pred,
              domain_ids=ids, domain="sketch", domainnet_classes=classes)
    got = port_lso.evaluate_lso(**kw)
    assert got == jax_lso.evaluate_lso(**kw)
    assert port_lso.merge_step_results([got, got], [1, 2], "sketch") == \
        jax_lso.merge_step_results([got, got], [1, 2], "sketch")
    for f in ("epoch_3.pt", "run_step_1200.pt"):
        assert port_lso.epoch_or_step_from_ckpt_file(f) == jax_lso.epoch_or_step_from_ckpt_file(f)


def test_lso_metrics_domainnet_only_and_classes_match_jax():
    """The supervised protocol's DomainNet-only metrics (no ImageNet-val
    predictions), a custom ``class_to_idx`` and ``merge_step_results(...,
    classes=)`` give JAX's dicts; one of ``val_labels`` / ``val_pred``
    alone is refused, as in JAX."""
    from xclip_tpu.evals import lso as jax_lso
    from xclip_tpu_torch.evals import lso as port_lso

    rng = np.random.RandomState(1)
    classes = dict(enumerate(_classnames()))
    labels = np.concatenate([np.arange(345), np.arange(345)])
    ids = np.array([4] * 345 + [1] * 345)  # real, infograph
    pred = np.where(rng.rand(690) < 0.3, labels, rng.randint(0, 345, 690))
    kw = dict(domain_labels=labels, domain_pred=pred, domain_ids=ids, domain="infograph", domainnet_classes=classes)
    got = port_lso.evaluate_lso(**kw)
    assert got == jax_lso.evaluate_lso(**kw) and got["imagenet-val"] == {"accuracy": {}}
    sub = {"banana": 13, "lion": 174, "thing 7": 7}
    assert port_lso.evaluate_lso(class_to_idx=sub, **kw) == jax_lso.evaluate_lso(class_to_idx=sub, **kw)
    assert port_lso.merge_step_results([got], [0], "infograph", classes=list(sub)) == \
        jax_lso.merge_step_results([got], [0], "infograph", classes=list(sub))
    with pytest.raises(ValueError, match="together"):
        port_lso.evaluate_lso(val_labels=labels[:3], **kw)


def test_top_k_accuracy_matches_jax_with_ties():
    """Integer scores with many ties: the same ``np.argpartition`` picks the
    same top k, so every k gives JAX's number."""
    from xclip_tpu.evals import lso as jax_lso
    from xclip_tpu_torch.evals import lso as port_lso

    rng = np.random.RandomState(2)
    scores = rng.randint(0, 4, (200, 12)).astype(np.float32)
    labels = rng.randint(0, 12, 200)
    for k in (1, 2, 5, 11, 12, 20):
        assert port_lso.top_k_accuracy(scores, labels, k) == jax_lso.top_k_accuracy(scores, labels, k), k


@pytest.mark.parametrize("case", ["random", "missing_from_pred", "missing_from_true", "perfect", "one_sample"])
def test_f1_macro_matches_sklearn(case):
    """``lso.f1_macro`` equals ``sklearn.metrics.f1_score(average="macro")``
    (which the JAX top-k evaluator calls) to the last bit, with classes that
    occur only in the labels or only in the predictions."""
    from sklearn.metrics import f1_score

    from xclip_tpu_torch.evals.lso import f1_macro

    rng = np.random.RandomState(3)
    y_true = rng.randint(0, 20, 300)
    y_pred = {"random": rng.randint(0, 20, 300), "missing_from_pred": np.where(y_true < 5, 6, y_true),
              "missing_from_true": np.where(rng.rand(300) < 0.2, 25 + rng.randint(0, 3, 300), y_true),
              "perfect": y_true.copy(), "one_sample": None}[case]
    if case == "one_sample":
        y_true, y_pred = np.array([3]), np.array([4])
    assert f1_macro(y_true, y_pred) == float(f1_score(y_true, y_pred, average="macro"))


def test_topk_lso_slice_matches_jax(eval_tree, tiny_ckpt, tmp_path, monkeypatch):
    """``run_lso_evaluation(..., topk=[1, 2])`` in both packages on the tiny
    harness above (the port through the top-k script's CLI): the same keys;
    top-1 equals the accuracy; and, where no prediction sits on a near tie,
    the same numbers (JAX's macro F1 is sklearn's)."""
    from xclip_tpu_torch.scripts import evaluate_domainnet_lso_openai_topk as topk_script

    monkeypatch.setitem(jax_factory._MODEL_CONFIGS, "TinyRN", TINY)
    monkeypatch.setitem(port_factory._MODEL_CONFIGS, "TinyRN", TINY)
    monkeypatch.setattr(jax_run_lso, "XCLIP_IMAGENET_CLASSES", IMAGENET_CLASSES)
    monkeypatch.setattr(port_run_lso, "XCLIP_IMAGENET_CLASSES", IMAGENET_CLASSES)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    want = jax_run_lso.run_lso_evaluation(
        "TinyRN", [str(tiny_ckpt)], str(jax_out), str(eval_tree / "imagenet"), str(eval_tree / "domainnet"),
        domain="sketch", num_workers=2, topk=[1, 2])
    assert topk_script.main([
        "--model", "TinyRN", "--domain", "sketch", "--ckpt_files", str(tiny_ckpt), "--out_path", str(port_out),
        "--imagenet_path", str(eval_tree / "imagenet"), "--domainnet_path", str(eval_tree / "domainnet"),
        "--num_workers", "0", "--topk", "1", "2", "--device", "cpu"]) == 0
    got = json.loads((port_out / "results.json").read_text())
    for split in ("imagenet-val", "domainnet-val"):
        assert set(got[split]) == set(want[split]) >= {"accuracy", "top-1-accuracy", "top-2-accuracy", "f1-score"}
        for key in ("top-1-accuracy", "top-2-accuracy", "f1-score"):
            assert set(got[split][key]) == set(want[split][key])
    acc, top1 = got["domainnet-val"]["accuracy"], got["domainnet-val"]["top-1-accuracy"]
    assert all(top1[k] == acc[k] for k in top1)
    assert got["imagenet-val"]["top-1-accuracy"] == got["imagenet-val"]["accuracy"]
    same = all(np.array_equal(np.load(port_out / f), np.load(jax_out / f)) for f in ("val_pred.npy", "domain_pred.npy"))
    if same:
        assert got == json.loads((jax_out / "results.json").read_text())


def test_topk_script_defaults():
    from xclip_tpu_torch.evals import run_lso

    args = run_lso.build_parser([1, 5, 10]).parse_args(
        ["--model", "RN50", "--domain", "sketch", "--ckpt_files", "a.pt", "--out_path", "o", "--imagenet_path", "i",
         "--domainnet_path", "d"])
    assert (args.topk, args.precision, args.device) == ([1, 5, 10], "fp32", "cuda")
    assert run_lso.build_parser().parse_args(
        ["--model", "RN50", "--domain", "sketch", "--ckpt_files", "a.pt", "--out_path", "o", "--imagenet_path", "i",
         "--domainnet_path", "d"]).topk is None
