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
from test_torch_models import TINY, _randomize_bn
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
