"""Dataset indexes: ImageNet folders, the DomainNet TSVs, the training
sets and the supervised baseline's joint label space.

Copies from ``xclip_tpu/data/datasets.py``:

- ``ImageFolderIndex``, ``ImageNet``, ``ImageNetV2``, ``DomainNetCaptions``
  and ``DOMAIN_TO_IDX`` (:26-125, :222-268), without ImageNet's class
  remapping; ``DomainNetCaptions`` with JAX's domain exclusion, class
  filter, ``samples_per_domain``, ``to_tsv`` (the LSO mixtures,
  ``data/lso.py``) and modes (the image with its label and/or caption, or
  alone: ``mode="none"``, the SAE feature cache); batched by
  ``torch.utils.data.DataLoader`` (``evals/features.py``) or
  ``data/loader.py`` (``sae/cache.py``);
- ``TsvDataset`` (``filepath\\ttitle``) and ``SyntheticDataset`` (:270-375),
  (image, caption) samples for training, or the image alone
  (``return_caption=False``), batched by ``data/loader.py``;
- ``CorruptedImageNet`` and ``ImageNetSketch`` with ``class_idcs``
  remapping (``_remap_classes``), ``ImageNetCaptions`` (both JSON layouts,
  the modes ``label``, ``caption``, ``label+caption`` and ``path``, and
  ``to_tsv``), ``CombinedNet`` (the 1345-way ImageNet + DomainNet label
  space of the supervised baseline), ``CompositionDataset`` (MIT-States /
  UT-Zappos, its ``.t7`` metadata read with ``torch.load``),
  ``subsample_per_class`` and ``load_antonym_data`` (:80-220, :300-493),
  with the JAX constructors' arguments and sample layouts.

``__getitem__`` returns numpy samples.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
from PIL import Image

ALL_DOMAINS = ["clipart", "infograph", "painting", "quickdraw", "real", "sketch"]
DOMAIN_TO_IDX = {d: i for i, d in enumerate(ALL_DOMAINS)}

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


def _imagenet_class_labels():
    # imported here: evals.metadata reads its JSON file on first access
    from xclip_tpu_torch.evals.metadata import XCLIP_IMAGENET_CLASSES

    return dict(enumerate(XCLIP_IMAGENET_CLASSES))


def _open_rgb(path: str) -> Image.Image:
    return Image.open(path).convert("RGB")


class ImageFolderIndex:
    """torchvision-ImageFolder-equivalent index: classes are the sorted
    subdirectory names; samples are (path, class_idx)."""

    def __init__(self, root: str, transform: Callable, target_transform: Optional[Callable] = None):
        self.root = root
        self.transform = transform
        self.target_transform = target_transform
        self.classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for cls in self.classes:
            cdir = os.path.join(root, cls)
            files = sorted(
                os.path.join(cdir, f) for f in os.listdir(cdir) if f.lower().endswith(IMG_EXTENSIONS)
            )
            self.samples.extend((f, self.class_to_idx[cls]) for f in files)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, label = self.samples[index]
        img = _open_rgb(path)
        if self.transform:
            img = self.transform(img)
        if self.target_transform:
            label = self.target_transform(label)
        return img, label


def _remap_classes(ds: ImageFolderIndex, class_idcs: Sequence[int]) -> None:
    """Keep the classes ``class_idcs`` (indices of the sorted class names),
    relabelled 0..n-1 in sorted order."""
    class_idcs = sorted(class_idcs)
    tgt_map = {c: i for i, c in enumerate(class_idcs)}
    ds.classes = [ds.classes[c] for c in class_idcs]
    ds.samples = [(p, tgt_map[t]) for p, t in ds.samples if t in tgt_map]
    ds.class_to_idx = {k: tgt_map[v] for k, v in ds.class_to_idx.items() if v in tgt_map}
    ds.class_labels = {tgt_map[k]: v for k, v in ds.class_labels.items() if k in tgt_map}


class ImageNet(ImageFolderIndex):
    """ImageNet ``root/{train,val}/<wnid>/``; labels index the sorted wnids."""

    def __init__(self, root: str, split: str, transform: Callable):
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split!r}")
        super().__init__(os.path.join(root, split), transform)


class ImageNetV2(ImageFolderIndex):
    """ImageNet-V2 tree (imagenetv2_pytorch's extracted layout): the class
    directories are the numeric ImageNet indices ``0`` ... ``999``, so a
    label is ``int(dirname)``, not the rank of the name. ``root`` is the
    tree or a directory holding exactly one ``imagenetv2-*`` tree."""

    def __init__(self, root: str, transform: Callable):
        if not any(d.name.isdigit() for d in os.scandir(root) if d.is_dir()):
            subs = [d.path for d in os.scandir(root) if d.is_dir() and d.name.startswith("imagenetv2-")]
            if len(subs) != 1:
                raise ValueError(f"no imagenetv2 class tree under {root}")
            root = subs[0]
        super().__init__(root, transform)
        self.samples = [(p, int(self.classes[t])) for p, t in self.samples]
        self.class_to_idx = {c: int(c) for c in self.classes}


class DomainNetCaptions:
    """Per-domain DomainNet TSV index with domain exclusion and class
    filtering. TSV rows: path\tlabel\tcaption; ``samples`` holds (path,
    label, caption), ``samples_per_domain`` the rows kept in each domain.
    ``filter_classes`` maps a domain to the labels dropped from it. An item
    is (image, label) with ``mode="label"`` (the default), the image alone
    with ``mode="none"``, (image, caption) with ``mode="caption"`` and
    (image, label, caption) with ``mode="label+caption"``. ``to_tsv``
    writes the ``filepath\ttitle`` training TSV of the samples."""

    def __init__(self, domainnet_path: str, split: str, transform: Callable,
                 exclude_domains: Sequence[str] = (), filter_classes: Optional[Dict[str, Set[int]]] = None,
                 mode: str = "label"):
        domainnet_path = os.path.abspath(domainnet_path)
        if split not in ("train", "val"):
            raise ValueError(f"split must be 'train' or 'val', got {split!r}")
        if mode not in ("none", "label", "caption", "label+caption"):
            raise ValueError(f"mode must be 'none', 'label', 'caption' or 'label+caption', got {mode!r}")
        filter_classes = filter_classes or {}
        self.return_label = "label" in mode
        self.return_caption = "caption" in mode
        split = "test" if split == "val" else split
        self.samples_per_domain = {d: 0 for d in ALL_DOMAINS}
        self.samples: List[Tuple[str, int, str]] = []
        for domain in ALL_DOMAINS:
            if domain in exclude_domains:
                continue
            with open(os.path.join(domainnet_path, f"{domain}_{split}.tsv")) as fh:
                rows = [line.split("\t") for line in fh.readlines()]
            samples = [(os.path.join(domainnet_path, p), int(label), caption.strip()) for p, label, caption in rows]
            if domain in filter_classes:
                samples = [s for s in samples if s[1] not in filter_classes[domain]]
            self.samples_per_domain[domain] = len(samples)
            self.samples.extend(samples)
        self.transform = transform

    def to_tsv(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write("filepath\ttitle\n")
            fh.writelines(f"{p}\t{caption}\n" for p, _, caption in self.samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, label, caption = self.samples[index]
        img = self.transform(Image.open(path))
        sample = (img,) + ((label,) if self.return_label else ()) + ((caption,) if self.return_caption else ())
        return sample if len(sample) > 1 else img


class TsvDataset:
    """``filepath\ttitle`` TSV of (image path, caption) rows; samples are
    (transformed image, caption), or the image alone with
    ``return_caption=False``."""

    def __init__(self, tsv_path: str, img_transform: Callable, return_caption: bool = True):
        with open(tsv_path) as fh:
            lines = fh.readlines()
        if not lines or lines[0].strip("\n") != "filepath\ttitle":
            raise ValueError(f"{tsv_path}: the first line must be the header 'filepath\\ttitle'")
        self.samples = [line.strip("\n").split("\t") for line in lines[1:]]
        self.img_transform = img_transform
        self.return_caption = return_caption

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, caption = self.samples[index]
        img = self.img_transform(Image.open(path).convert("RGB"))
        return (img, caption) if self.return_caption else img


class SyntheticDataset:
    """Random images (16 distinct ones, seeded) with a fixed caption, for runs
    without data on disk."""

    def __init__(self, transform: Callable, image_size: int = 224, caption: str = "Dummy caption",
                 dataset_size: int = 100, seed: int = 0):
        self.transform = transform
        self.caption = caption
        rng = np.random.RandomState(seed)
        self._images = [
            Image.fromarray(rng.randint(0, 256, (image_size, image_size, 3), np.uint8))
            for _ in range(min(dataset_size, 16))
        ]
        self.size = dataset_size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int):
        return self.transform(self._images[index % len(self._images)]), self.caption


class CorruptedImageNet(ImageFolderIndex):
    """ImageNet-C: ``root/<corruption>/<severity>/<wnid>/``."""

    def __init__(self, root: str, corruption: str, severity: int = 3, transform=None,
                 target_transform=None, class_idcs: Optional[Sequence[int]] = None, **_):
        path = os.path.join(root, corruption, str(severity))
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        super().__init__(path, transform, target_transform)
        self.class_labels = _imagenet_class_labels()
        if class_idcs is not None:
            _remap_classes(self, class_idcs)
        self.targets = np.array([t for _, t in self.samples])


class ImageNetSketch(ImageFolderIndex):
    """ImageNet-Sketch: ``root`` is the ``sketch`` tree or its parent."""

    def __init__(self, root: str, split: str = "sketch", transform=None,
                 target_transform=None, class_idcs: Optional[Sequence[int]] = None, **_):
        if split != "sketch":
            raise ValueError(f"split must be 'sketch', got {split!r}")
        path = root if root.endswith("sketch") else os.path.join(root, split)
        super().__init__(path, transform, target_transform)
        self.class_labels = _imagenet_class_labels()
        if class_idcs is not None:
            _remap_classes(self, class_idcs)
        self.targets = np.array([t for _, t in self.samples])


class ImageNetCaptions:
    """ImageNet-Captions JSON -> (image, label and/or caption) samples, with
    a ``to_tsv`` exporter. The JSON is either ``{"train": [[path, ...],
    ...], "val": [...]}`` (shards of paths ``<dir>/<wnid>/<file>``
    relative to ``imagenet_path``) or a list of ``{"wnid", "filename"}``
    records under ``imagenet_path/captions``; a caption is the
    ``"caption"`` field of the JSON file beside the image."""

    def __init__(self, shard_path: str, imagenet_path: str, split: str,
                 transform: Callable, target_transform=None, mode: str = "label"):
        shard_path = os.path.abspath(shard_path)
        imagenet_path = os.path.abspath(imagenet_path)
        self.class_to_idx = ImageNet(imagenet_path, "train", transform=None).class_to_idx

        with open(shard_path) as fh:
            json_data = json.load(fh)
        if any(s in json_data for s in ("train", "val")):
            if split not in ("train", "val"):
                raise ValueError(f"split must be 'train' or 'val', got {split!r}")
            img_paths = [p for shard in json_data[split] for p in shard]
            img_labels = [self.class_to_idx[self._wnid_from_path(p)] for p in img_paths]
        else:
            img_paths = [os.path.join("captions", d["wnid"], d["filename"]) for d in json_data]
            img_labels = [self.class_to_idx[d["wnid"]] for d in json_data]
        self.samples = [(os.path.join(imagenet_path, p), lab) for p, lab in zip(img_paths, img_labels)]

        if mode not in ("label", "caption", "label+caption", "path"):
            raise ValueError(f"mode must be 'label', 'caption', 'label+caption' or 'path', got {mode!r}")
        self.return_label = "label" in mode
        self.return_caption = "caption" in mode
        self.return_path = "path" in mode
        self.transform = transform
        self.target_transform = target_transform

    @staticmethod
    def _wnid_from_path(path: str) -> str:
        _, wnid, _ = path.split("/")
        if len(wnid) != 9:
            raise ValueError(f"{path}: {wnid!r} is not a wnid")
        return wnid

    def _caption_from_path(self, path: str) -> str:
        with open(f"{os.path.splitext(path)[0]}.json") as fh:
            return json.load(fh)["caption"]

    def to_tsv(self, path: str, preprocess_text: bool = True) -> None:
        from xclip_tpu_torch.data.text_clean import remove_html_tags

        with open(path, "w") as fh:
            fh.write("filepath\ttitle\n")
            for img_path, _ in self.samples:
                caption = self._caption_from_path(img_path).replace("\n", " ")
                if preprocess_text:
                    caption = remove_html_tags(caption)
                fh.write(f"{img_path}\t{caption}\n")

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, label = self.samples[index]
        img = self.transform(_open_rgb(path))
        if self.target_transform:
            label = self.target_transform(label)
        if self.return_path:
            return img, path
        sample = (img, label) if self.return_label else (img,)
        if self.return_caption:
            sample += (self._caption_from_path(path),)
        return sample


class CombinedNet:
    """The supervised baseline's joint 1345-way label space over a
    ``filepath\\ttitle`` TSV: a label comes from the image's parent
    directory. An ImageNet wnid maps through the class index, except that
    an ImageNet class that ``class_mapping`` folds into a DomainNet class
    becomes that class's index + 1000; a DomainNet class name (``_`` for
    spaces) becomes its index + 1000."""

    def __init__(self, index_path: str, in_class_index_path: str, class_mapping_path: str,
                 transform: Callable, target_transform=None):
        with open(in_class_index_path) as fh:
            in_class_index = json.load(fh)
        self.wnid_to_idx = {wnid: int(label) for label, (wnid, _) in in_class_index.items()}

        with open(class_mapping_path) as fh:
            class_mapping = json.load(fh)
        self.cls_to_idx = {c: i for i, c in enumerate(class_mapping)}
        assert self.cls_to_idx["banana"] == 13
        assert self.cls_to_idx["candle"] == 58
        assert self.cls_to_idx["lion"] == 174

        self.in_to_dn_idx = {
            in_idx: self.cls_to_idx[dn_cls]
            for dn_cls, in_indices in class_mapping.items()
            if in_indices is not None
            for in_idx in in_indices
        }

        with open(index_path) as fh:
            lines = fh.readlines()
        if not lines or lines[0] != "filepath\ttitle\n":
            raise ValueError(f"{index_path}: the first line must be the header 'filepath\\ttitle'")
        paths = [line.strip("\n").split("\t")[0] for line in lines[1:]]
        self.samples = [(p, self._label_from_path(p)) for p in paths]
        self.transform = transform
        self.target_transform = target_transform

    def _label_from_path(self, path: str) -> int:
        identifier = path.split("/")[-2].replace("_", " ").lower()
        if identifier in self.wnid_to_idx:
            if identifier in self.cls_to_idx:
                raise ValueError(f"{path}: {identifier!r} is both a wnid and a DomainNet class")
            in_label = self.wnid_to_idx[identifier]
            return self.in_to_dn_idx[in_label] + 1000 if in_label in self.in_to_dn_idx else in_label
        if identifier not in self.cls_to_idx:
            raise ValueError(f"{path}: {identifier!r} is neither a wnid nor a DomainNet class")
        return self.cls_to_idx[identifier] + 1000

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, label = self.samples[index]
        img = self.transform(_open_rgb(path))
        if self.target_transform:
            label = self.target_transform(label)
        return img, label


class CompositionDataset:
    """MIT-States / UT-Zappos attribute-object compositions: the published
    ``metadata_compositional-split-natural.t7`` (read with ``torch.load``),
    the pair lists under ``compositional-split-natural/`` and images under
    ``images/<attr> <obj>/``. An item is (image, attribute index), with
    ``also_return_obj_label`` also the object index, or with a
    ``target_transform`` (image, (captions, attribute index)), the captions
    made from the pair and the attributes (or, with ``antonym_prompts``,
    the attribute's antonyms from ``adj_ants.csv``)."""

    def __init__(self, root: str, split: str, transform: Callable, target_transform=None,
                 antonym_prompts: bool = False, also_return_obj_label: bool = False):
        import torch

        self.root = root
        self.split = split
        self.metadata = torch.load(os.path.join(root, "metadata_compositional-split-natural.t7"),
                                   weights_only=False)

        all_info, split_info = self._parse_split()
        self.attrs, self.objs, self.pairs = all_info
        self.train_pairs, self.valid_pairs, self.test_pairs = split_info

        self.obj2idx = {o: i for i, o in enumerate(self.objs)}
        self.attr2idx = {a: i for i, a in enumerate(self.attrs)}
        self.pair2idx = {p: i for i, p in enumerate(self.pairs)}
        self.idx2obj = {i: o for o, i in self.obj2idx.items()}
        self.idx2attr = {i: a for a, i in self.attr2idx.items()}
        self.idx2pair = {i: p for p, i in self.pair2idx.items()}
        self.unique_objs = list({noun for _, noun in self.pairs})
        self.unique_attrs = list({attr for attr, _ in self.pairs})
        self.antonym_data = load_antonym_data(root)
        if antonym_prompts and not self.antonym_data:
            raise ValueError(f"antonym_prompts needs {os.path.join(root, 'adj_ants.csv')}")

        self.train_data, self.valid_data, self.test_data = self._get_split_info()
        self.data = {"train": self.train_data, "valid": self.valid_data}.get(split, self.test_data)
        self.sample_indices = list(range(len(self.data)))
        self.sample_pairs = self.train_pairs

        self.transform = transform
        self.target_transform = target_transform
        self.antonym_prompts = antonym_prompts
        self.also_return_obj_label = also_return_obj_label

    def _parse_split(self):
        def parse_pairs(path):
            with open(path) as fh:
                pairs = [tuple(t.split()) for t in fh.read().strip().split("\n")]
            attrs, objs = zip(*pairs)
            return attrs, objs, pairs

        base = os.path.join(self.root, "compositional-split-natural")
        tr = parse_pairs(os.path.join(base, "train_pairs.txt"))
        vl = parse_pairs(os.path.join(base, "val_pairs.txt"))
        ts = parse_pairs(os.path.join(base, "test_pairs.txt"))
        all_attrs = sorted(set(tr[0] + vl[0] + ts[0]))
        all_objs = sorted(set(tr[1] + vl[1] + ts[1]))
        all_pairs = sorted(set(tr[2] + vl[2] + ts[2]))
        return (all_attrs, all_objs, all_pairs), (tr[2], vl[2], ts[2])

    def _get_split_info(self):
        train, val, test = [], [], []
        for inst in self.metadata:
            image, attr, obj, settype = inst["image"], inst["attr"], inst["obj"], inst["set"]
            image = os.path.join(self.root, "images", f"{attr} {obj}", image.split("/")[1])
            if attr == "NA" or (attr, obj) not in self.pairs or settype == "NA":
                continue
            rec = {
                "image_path": image, "attr": attr, "obj": obj, "pair": (attr, obj),
                "attr_id": self.attr2idx[attr], "obj_id": self.obj2idx[obj],
                "pair_id": self.pair2idx[(attr, obj)],
            }
            {"train": train, "val": val}.get(settype, test).append(rec)
        return train, val, test

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int):
        rec = self.data[self.sample_indices[index]]
        img = self.transform(Image.open(rec["image_path"]))
        if self.target_transform:
            if self.antonym_prompts:
                captions = self.target_transform(rec["pair"], self.antonym_data[rec["attr"]], self.unique_objs)
            else:
                captions = self.target_transform(rec["pair"], self.unique_attrs, self.unique_objs)
            return img, (captions, self.attr2idx[rec["pair"][0]])
        if self.also_return_obj_label:
            return img, self.attr2idx[rec["pair"][0]], rec["obj_id"]
        return img, self.attr2idx[rec["pair"][0]]


def subsample_per_class(dataset, k: int = 50, seed: int = 0):
    """Keep at most k random samples per class (the 50-per-class
    ImageNet-train eval subset). Mutates and returns the dataset."""
    rng = np.random.RandomState(seed)
    targets = np.array([t for _, t in dataset.samples])
    keep = np.zeros(len(targets), bool)
    for c in np.unique(targets):
        idx = np.where(targets == c)[0]
        rng.shuffle(idx)
        keep[idx[:k]] = True
    dataset.samples = [s for s, kp in zip(dataset.samples, keep) if kp]
    dataset.targets = np.array([t for _, t in dataset.samples])
    return dataset


def load_antonym_data(data_root: str) -> dict:
    """``adj_ants.csv`` under ``data_root`` as {adjective: [antonyms]}; {}
    when the file is absent."""
    antonyms = {}
    path = os.path.join(data_root, "adj_ants.csv")
    if not os.path.isfile(path):
        return antonyms
    with open(path) as fh:
        for line in fh:
            words = line.strip(",\n").split(",")
            antonyms[words[0]] = words[1:] if len(words) > 1 else []
    return antonyms
