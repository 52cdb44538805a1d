"""Synthetic caption generation for DomainNet, ImageNet-Sketch and ImageNet.

A copy of ``xclip_tpu/data/captions.py`` (reference
scripts/generate_domainnet_captions.py, generate_sketch_captions.py and
generate_imagenet_captions.py):

- :func:`generate_domainnet_captions` writes ``{domain}_{split}.tsv``
  (``path\tlabel\tcaption``) beside each DomainNet list: one of 6
  templates with a domain or generic term and its article, the full stop
  dropped at random; then re-seeds and writes the ``aligned-captions``
  variant (generic terms only), whose ``<domain>`` folders are symlinks to
  the images;
- :func:`generate_sketch_captions` writes ``in-sketch-captions.tsv`` from
  21 templates over the port's ``ImageNetSketch`` index;
- :func:`generate_imagenet_captions` writes ``in-captions-{train,val}.tsv``
  from ImageNet-Captions (``title; tags; description``, whitespace
  normalized as textacy does) and a ``.json`` sidecar beside every image.

The calls to stdlib ``random`` come in JAX's order, so an equal seed gives
byte-identical files.
"""

from __future__ import annotations

import json
import os
import random
import warnings
from typing import Dict, List

from xclip_tpu_torch.data.datasets import ALL_DOMAINS
from xclip_tpu_torch.data.text_clean import normalize_whitespace_textacy

DOMAIN_TERMS: Dict[str, List[str]] = {
    "all": ["image", "picture"],
    "clipart": ["clipart", "illustration"],
    "infograph": ["infograph", "informational chart"],
    "painting": ["painting", "art"],
    "quickdraw": ["quickdraw", "doodle"],
    "real": ["photo", "snapshot"],
    "sketch": ["sketch", "drawing"],
}

ARTICLES: Dict[str, str] = {
    "image": "an ", "picture": "a ", "clipart": "a ", "illustration": "an ",
    "infograph": "an ", "informational chart": "an ", "painting": "a ", "art": "",
    "quickdraw": "a ", "doodle": "a ", "photo": "a ", "snapshot": "a ",
    "sketch": "a ", "drawing": "a ",
}

DOMAINNET_TEMPLATES = [
    "{AAN}{TERM} of a {CLS}.",
    "a {CLS} {TERM}.",
    "{AAN}{TERM} depicting a {CLS}.",
    "a {CLS} depicted in {AAN}{TERM}.",
    "{AAN}{TERM} showing a {CLS}.",
    "a {CLS} is visible in {AAN}{TERM}.",
]

SKETCH_TEMPLATES = [
    "{}.", "a {}.", "the {}.",
    "{} drawing.", "drawing of a {}.", "drawing of the {}.",
    "a {} drawing.", "a drawing of a {}.", "a drawing of the {}.",
    "{} sketch.", "sketch of a {}.", "sketch of the {}.",
    "a {} sketch.", "a sketch of a {}.", "a sketch of the {}.",
    "{} image.", "image of a {}.", "image of the {}.",
    "a {} image.", "an image of a {}.", "an image of the {}.",
]


def domainnet_caption_line(sample: str, exclude_domain_terms: bool, rng=random) -> str:
    """Turn a DomainNet list line 'path label' into 'path\tlabel\tcaption'
    (reference insert_caption_to_sample, :46-60)."""
    path, label = sample.split()
    domain, cls, *_ = path.split("/")
    cls = cls.replace("_", " ")

    template = rng.choice(DOMAINNET_TEMPLATES)
    assert template[-1] == "."
    template = template if rng.random() < 0.5 else template[:-1]

    pool = DOMAIN_TERMS["all"] if exclude_domain_terms else DOMAIN_TERMS["all"] + DOMAIN_TERMS[domain]
    term = rng.choice(pool)
    return "\t".join([path, label, template.format(CLS=cls, TERM=term, AAN=ARTICLES[term])])


def generate_domainnet_captions(domainnet_path: str, seed: int = 42) -> None:
    """Write {domain}_{split}.tsv plus the aligned-captions variant."""
    random.seed(seed)
    for domain in ALL_DOMAINS:
        for split in ("train", "test"):
            with open(os.path.join(domainnet_path, f"{domain}_{split}.txt")) as fh:
                samples = fh.readlines()
            out = [domainnet_caption_line(s, exclude_domain_terms=False) + "\n" for s in samples]
            with open(os.path.join(domainnet_path, f"{domain}_{split}.tsv"), "w") as fh:
                fh.writelines(out)

    random.seed(seed)  # reference re-seeds for the aligned pass (:78)
    aligned_root = os.path.join(domainnet_path, "aligned-captions")
    os.makedirs(aligned_root, exist_ok=True)
    for domain in ALL_DOMAINS:
        link = os.path.join(aligned_root, domain)
        if not os.path.lexists(link):
            os.symlink(os.path.join(domainnet_path, domain), link)
        for split in ("train", "test"):
            with open(os.path.join(domainnet_path, f"{domain}_{split}.txt")) as fh:
                samples = fh.readlines()
            out = [domainnet_caption_line(s, exclude_domain_terms=True) + "\n" for s in samples]
            with open(os.path.join(aligned_root, f"{domain}_{split}.tsv"), "w") as fh:
                fh.writelines(out)


def sketch_caption(name: str, rng=random) -> str:
    template = rng.choice(SKETCH_TEMPLATES)
    assert template[-1] == "."
    template = template if rng.random() < 0.5 else template[:-1]
    return template.format(name)


def generate_sketch_captions(imagenet_path: str, seed: int = 42) -> None:
    from xclip_tpu_torch.data.datasets import ImageNetSketch

    random.seed(seed)
    assert os.path.isdir(os.path.join(imagenet_path, "sketch"))
    dataset = ImageNetSketch(imagenet_path, transform=None)
    with open(os.path.join(imagenet_path, "in-sketch-captions.tsv"), "w") as fh:
        fh.write("filepath\ttitle\n")
        for path, label in dataset.samples:
            path = os.path.abspath(os.path.join(imagenet_path, path))
            assert os.path.isfile(path)
            fh.write(f"{path}\t{sketch_caption(dataset.class_labels[label])}\n")


def imagenet_caption_from_sample(sample: dict) -> str:
    """title;tags;description (reference create_caption_from_sample,
    scripts/generate_imagenet_captions.py:11-22): textacy-exact whitespace
    normalization so the TSV bytes match on newline-bearing Flickr text."""
    title = sample["title"]
    tags = " ".join(sample["tags"])
    desc = sample["description"]
    caption = "; ".join(part for part in (title, tags, desc) if part != "")
    return normalize_whitespace_textacy(caption)


def generate_imagenet_captions(
    imagenet_train_path: str,
    imagenet_captions_path: str,
    imagenet_captions_split_path: str,
    out_path: str,
    seed: int = 42,
) -> None:
    random.seed(seed)
    with open(imagenet_captions_path) as fh:
        captions = json.load(fh)
    with open(imagenet_captions_split_path) as fh:
        split = json.load(fh)
    train_samples, val_samples = set(split["train"]), set(split["val"])

    train_tsv, val_tsv = ["filepath\ttitle\n"], ["filepath\ttitle\n"]
    skipped = 0
    for sample in captions:
        path = os.path.abspath(os.path.join(imagenet_train_path, sample["wnid"], sample["filename"]))
        assert os.path.isfile(path), path
        caption = imagenet_caption_from_sample(sample).replace("\n", " ")
        with open(f"{os.path.splitext(path)[0]}.json", "w") as fh:
            json.dump({"caption": caption}, fh)
        if sample["filename"] in train_samples:
            train_tsv.append(f"{path}\t{caption}\n")
        elif sample["filename"] in val_samples:
            val_tsv.append(f"{path}\t{caption}\n")
        else:
            warnings.warn(f"Filename {sample['filename']} not in train/val split; skipped.")
            skipped += 1

    os.makedirs(out_path, exist_ok=True)
    with open(os.path.join(out_path, "in-captions-train.tsv"), "w") as fh:
        fh.writelines(train_tsv)
    with open(os.path.join(out_path, "in-captions-val.tsv"), "w") as fh:
        fh.writelines(val_tsv)
