"""The port's dataset classes of the supervised and evaluation surface
against the JAX package's on tiny seeded trees: the same samples, labels
and items (images byte for byte through the same transform).

- ``CombinedNet`` with the repository's real ``data/`` mapping files: an
  ImageNet wnid, a wnid folded into a DomainNet class, and DomainNet class
  folders (one name with a space);
- ``ImageNetCaptions`` in both JSON layouts and all four modes, plus
  ``to_tsv``;
- ImageNet-C and ImageNet-Sketch with and without ``class_idcs``;
- ``subsample_per_class`` at equal seeds;
- ``CompositionDataset`` on a tiny ``.t7`` written with ``torch.save``,
  with the antonym file, in each split and item layout;
- ``text_clean`` and the meters, which are copies.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import release_memory_after_module  # noqa: F401
from xclip_tpu.data import datasets as jax_ds
from xclip_tpu.data import text_clean as jax_text_clean
from xclip_tpu.data.transforms import image_transform as jax_image_transform
from xclip_tpu.utils import meters as jax_meters
from xclip_tpu_torch.data import datasets as port_ds
from xclip_tpu_torch.data import text_clean
from xclip_tpu_torch.data.transforms import image_transform
from xclip_tpu_torch.utils import meters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16


def _save(path, rng, size=(20, 24)):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (size[1], size[0], 3), np.uint8)).save(path)


def _same_items(got, want, indices):
    assert len(got) == len(want)
    for i in indices:
        a, b = got[i], want[i]
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
            else:
                assert x == y


def _tf():
    return image_transform(SIZE), jax_image_transform(SIZE, is_train=False)


def test_combined_net_matches_jax(tmp_path):
    index = json.loads(open(os.path.join(REPO, "data", "imagenet_class_index.json")).read())
    mapping = json.loads(open(os.path.join(REPO, "data", "in_to_dn_mapping.json")).read())
    folded = sorted({i for v in mapping.values() if v for i in v})
    kept = [i for i in range(1000) if i not in folded][:2]
    parents = [index[str(i)][0] for i in kept + folded[:2]] + ["traffic_light", "banana", "aircraft_carrier",
                                                               "zebra"]
    rng = np.random.RandomState(0)
    rows = []
    for parent in parents:
        for j in range(2):
            p = tmp_path / "imgs" / parent / f"{j}.jpg"
            _save(p, rng)
            rows.append(f"{p}\ta caption {j}\n")
    (tmp_path / "idx.tsv").write_text("filepath\ttitle\n" + "".join(rows))
    args = (str(tmp_path / "idx.tsv"), os.path.join(REPO, "data", "imagenet_class_index.json"),
            os.path.join(REPO, "data", "in_to_dn_mapping.json"))
    tf, jtf = _tf()
    got, want = port_ds.CombinedNet(*args, transform=tf), jax_ds.CombinedNet(*args, transform=jtf)
    assert got.samples == want.samples
    labels = [lab for _, lab in got.samples]
    assert labels[0::2][:2] == kept
    assert all(lab >= 1000 for lab in labels[4:]) and max(labels) < 1345
    assert got.in_to_dn_idx == want.in_to_dn_idx and got.cls_to_idx == want.cls_to_idx
    _same_items(got, want, range(0, len(got), 3))
    bad = tmp_path / "bad.tsv"
    bad.write_text(f"filepath\ttitle\n{tmp_path}/imgs/not_a_class/0.jpg\tx\n")
    with pytest.raises(ValueError, match="neither"):
        port_ds.CombinedNet(str(bad), *args[1:], transform=tf)


def _imagenet_captions_tree(tmp_path):
    rng = np.random.RandomState(1)
    wnids = ["n00000001", "n00000002", "n00000003"]
    for w in wnids:
        _save(tmp_path / "inet" / "train" / w / "a.JPEG", rng)
    records, shards = [], {"train": [[], []], "val": [[]]}
    for k, w in enumerate(wnids):
        for j in range(2):
            name = f"{w}_{j}.JPEG"
            p = tmp_path / "inet" / "captions" / w / name
            _save(p, rng)
            (p.parent / f"{w}_{j}.json").write_text(json.dumps({"caption": f"<b>a</b> photo\nof {w} {j}"}))
            records.append({"wnid": w, "filename": name})
            shards["train" if j == 0 else "val"][k % len(shards["train" if j == 0 else "val"])].append(
                f"captions/{w}/{name}")
    (tmp_path / "records.json").write_text(json.dumps(records))
    (tmp_path / "shards.json").write_text(json.dumps(shards))
    return tmp_path / "inet"


@pytest.mark.parametrize("layout", ["records", "shards"])
@pytest.mark.parametrize("mode", ["label", "caption", "label+caption", "path"])
def test_imagenet_captions_matches_jax(tmp_path, layout, mode):
    root = _imagenet_captions_tree(tmp_path)
    tf, jtf = _tf()
    splits = ["train"] if layout == "records" else ["train", "val"]
    for split in splits:
        kw = dict(shard_path=str(tmp_path / f"{layout}.json"), imagenet_path=str(root), split=split, mode=mode)
        got = port_ds.ImageNetCaptions(transform=tf, **kw)
        want = jax_ds.ImageNetCaptions(transform=jtf, **kw)
        assert got.samples == want.samples and got.class_to_idx == want.class_to_idx
        _same_items(got, want, range(len(got)))
        if mode == "label":
            got.to_tsv(str(tmp_path / "got.tsv"))
            want.to_tsv(str(tmp_path / "want.tsv"))
            assert (tmp_path / "got.tsv").read_bytes() == (tmp_path / "want.tsv").read_bytes()
            got.to_tsv(str(tmp_path / "got.tsv"), preprocess_text=False)
            want.to_tsv(str(tmp_path / "want.tsv"), preprocess_text=False)
            assert (tmp_path / "got.tsv").read_bytes() == (tmp_path / "want.tsv").read_bytes()


def _folder_tree(root, classes, per_class, rng):
    for c in classes:
        for j in range(per_class):
            _save(root / c / f"{j}.jpg", rng)


@pytest.mark.parametrize("class_idcs", [None, [3, 0, 2]])
def test_imagenet_c_and_sketch_match_jax(tmp_path, class_idcs):
    rng = np.random.RandomState(2)
    classes = [f"n{i:08d}" for i in range(5)]
    _folder_tree(tmp_path / "inc" / "fog" / "3", classes, 2, rng)
    _folder_tree(tmp_path / "sk" / "sketch", classes, 2, rng)
    tf, jtf = _tf()
    pairs = [
        (port_ds.CorruptedImageNet(str(tmp_path / "inc"), "fog", transform=tf, class_idcs=class_idcs),
         jax_ds.CorruptedImageNet(str(tmp_path / "inc"), "fog", transform=jtf, class_idcs=class_idcs)),
        (port_ds.ImageNetSketch(str(tmp_path / "sk"), transform=tf, class_idcs=class_idcs),
         jax_ds.ImageNetSketch(str(tmp_path / "sk"), transform=jtf, class_idcs=class_idcs)),
        (port_ds.ImageNetSketch(str(tmp_path / "sk" / "sketch"), transform=tf, class_idcs=class_idcs,
                                target_transform=lambda t: t + 10),
         jax_ds.ImageNetSketch(str(tmp_path / "sk" / "sketch"), transform=jtf, class_idcs=class_idcs,
                               target_transform=lambda t: t + 10)),
    ]
    for got, want in pairs:
        assert got.samples == want.samples and got.classes == want.classes
        assert got.class_to_idx == want.class_to_idx and got.class_labels == want.class_labels
        np.testing.assert_array_equal(got.targets, want.targets)
        _same_items(got, want, range(len(got)))
    if class_idcs is not None:
        assert pairs[0][0].classes == [classes[0], classes[2], classes[3]]
    with pytest.raises(FileNotFoundError):
        port_ds.CorruptedImageNet(str(tmp_path / "inc"), "snow", transform=tf)


@pytest.mark.parametrize("seed", [0, 5])
def test_subsample_per_class_matches_jax(tmp_path, seed):
    rng = np.random.RandomState(3)
    classes = [f"n{i:08d}" for i in range(4)]
    for i, c in enumerate(classes):
        for j in range(3 + 2 * i):
            _save(tmp_path / "inet" / "val" / c / f"{j}.jpg", rng, size=(4, 4))
    got = port_ds.subsample_per_class(port_ds.ImageNet(str(tmp_path / "inet"), "val", transform=None), k=4,
                                      seed=seed)
    want = jax_ds.subsample_per_class(jax_ds.ImageNet(str(tmp_path / "inet"), "val"), k=4, seed=seed)
    assert got.samples == want.samples and len(got.samples) == 3 + 4 * 3
    np.testing.assert_array_equal(got.targets, want.targets)


def _composition_tree(tmp_path, with_antonyms: bool):
    rng = np.random.RandomState(4)
    root = tmp_path / "mit"
    split = root / "compositional-split-natural"
    split.mkdir(parents=True)
    pairs = {"train": ["ancient house", "broken bottle", "old car"], "val": ["ancient car", "new bottle"],
             "test": ["broken house", "old bottle", "new car"]}
    for name, ps in pairs.items():
        (split / f"{name}_pairs.txt").write_text("\n".join(ps) + "\n")
    meta = []
    for k, (settype, ps) in enumerate([("train", pairs["train"]), ("val", pairs["val"]), ("test", pairs["test"])]):
        for j, pair in enumerate(ps):
            attr, obj = pair.split()
            fname = f"img_{k}_{j}.jpg"
            _save(root / "images" / f"{attr} {obj}" / fname, rng)
            meta.append({"image": f"{attr}_{obj}/{fname}", "attr": attr, "obj": obj, "set": settype})
    meta.append({"image": "x_y/na.jpg", "attr": "NA", "obj": "car", "set": "train"})
    meta.append({"image": "x_y/na2.jpg", "attr": "old", "obj": "car", "set": "NA"})
    meta.append({"image": "x_y/unk.jpg", "attr": "shiny", "obj": "car", "set": "train"})
    torch.save(meta, root / "metadata_compositional-split-natural.t7")
    if with_antonyms:
        (root / "adj_ants.csv").write_text("ancient,new,modern\nbroken,fixed,\nold,new\nnew,old\nlonely,\n")
    return root


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_composition_dataset_matches_jax(tmp_path, split):
    root = _composition_tree(tmp_path, with_antonyms=True)
    tf, jtf = _tf()

    def captions(pair, attrs, objs):
        return [f"{a} {pair[1]}" for a in sorted(attrs)] + [str(len(objs))]

    variants = [dict(), dict(also_return_obj_label=True), dict(target_transform=captions),
                dict(target_transform=captions, antonym_prompts=True)]
    for kw in variants:
        got = port_ds.CompositionDataset(str(root), split, tf, **kw)
        want = jax_ds.CompositionDataset(str(root), split, jtf, **kw)
        for attr in ("attrs", "objs", "pairs", "train_pairs", "valid_pairs", "test_pairs", "data", "antonym_data"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert sorted(got.unique_objs) == sorted(want.unique_objs)
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert a[0].tobytes() == b[0].tobytes()
            if "target_transform" in kw:  # the captions list the attributes in set order
                assert sorted(a[1][0]) == sorted(b[1][0]) and a[1][1] == b[1][1]
            else:
                assert a[1:] == b[1:]
    assert port_ds.load_antonym_data(str(root)) == jax_ds.load_antonym_data(str(root))
    assert port_ds.load_antonym_data(str(tmp_path)) == {} == jax_ds.load_antonym_data(str(tmp_path))


def test_composition_dataset_needs_antonyms_for_antonym_prompts(tmp_path):
    root = _composition_tree(tmp_path, with_antonyms=False)
    with pytest.raises(ValueError, match="adj_ants.csv"):
        port_ds.CompositionDataset(str(root), "train", image_transform(SIZE), antonym_prompts=True)


def test_text_clean_and_meters_match_jax(capsys):
    texts = ["<p>a <b>bold</b> cap&amp;tion</p>", "a​ zero\r\n\n width \t space ", "plain", ""]
    for t in texts:
        assert text_clean.remove_html_tags(t) == jax_text_clean.remove_html_tags(t)
        assert text_clean.unescape_html(t) == jax_text_clean.unescape_html(t)
        assert text_clean.normalize_whitespace(t) == jax_text_clean.normalize_whitespace(t)
        assert text_clean.normalize_whitespace_textacy(t) == jax_text_clean.normalize_whitespace_textacy(t)
    got, want = meters.AverageMeter(), jax_meters.AverageMeter()
    for v, n in ((1.5, 2), (3.0, 1), (0.25, 4)):
        got.update(v, n)
        want.update(v, n)
        assert vars(got) == vars(want)
    root = logging.getLogger()
    saved = list(root.handlers), root.level
    try:
        handlers = meters.setup_logging(None)
        assert root.handlers == handlers and len(handlers) == 1
        logging.info("hello %d", 3)
        assert capsys.readouterr().out.rstrip().endswith(" | INFO | hello 3")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])
