"""Auxiliary mixtures: the CC3M/CC12M merge and the ImageNet-Sketch mixes.

A copy of ``xclip_tpu/data/mixtures.py`` (reference scripts/merge_ccxm.py,
add_in_sketches.py and mix_in_sketches.py): :func:`merge_ccxm` prepends
the ccXm train TSV to the 7 ``PAPER_MIXTURES``; :func:`add_in_sketches`
swaps ImageNet-Sketch samples into 3 mixtures at equal size;
:func:`mix_in_sketches` keeps {50, 30, 25, 10, 5, 1} % or one of the 330
DomainNet sketch classes, backfills with ImageNet sketches and trims the
other DomainNet samples to size. The draws follow JAX's call order with
seed 42. The ``-thirtyp`` draw samples from a list built from a set of
strings, so its output depends on ``PYTHONHASHSEED``: it equals JAX's
within one interpreter, as the reference's does.
"""

from __future__ import annotations

import json
import os
import random
from typing import List

from xclip_tpu_torch.evals.metadata import XCLIP_IMAGENET_CLASSES

PAPER_MIXTURES = [
    "lso-rs-nosketchclasses",
    "lso-cipqrs-nosketchclasses",
    "lso-cipqr-nosketchclasses",
    "lso-cr-noclipartclasses",
    "lso-cipqrs-noclipartclasses",
    "lso-ipqrs-noclipartclasses",
    "lso-real-only",
]


def _read_tsv_body(path: str) -> List[str]:
    with open(path) as fh:
        lines = fh.readlines()
    assert lines[0] == "filepath\ttitle\n", path
    return lines[1:]


def merge_ccxm(mode: str, indices_path: str = "data/indices",
               identifiers: List[str] = PAPER_MIXTURES) -> None:
    assert mode in ("cc3m", "cc12m")
    with open(os.path.join(indices_path, f"{mode}-train.tsv")) as fh:
        ccxm_train = fh.readlines()
    for identifier in identifiers:
        out = os.path.join(indices_path, f"{mode}-train-{identifier}.tsv")
        if os.path.isfile(out):
            continue
        dn_train = _read_tsv_body(os.path.join(indices_path, f"dn-captions-train-{identifier}.tsv"))
        with open(out, "w") as fh:
            fh.writelines(ccxm_train + dn_train)


def _shared_class_names(class_mapping_path: str) -> List[str]:
    class_labels = dict(enumerate(XCLIP_IMAGENET_CLASSES))
    with open(class_mapping_path) as fh:
        in_to_dn = json.load(fh)
    shared = []
    for clss in in_to_dn.values():
        if clss is not None:
            shared.extend(clss)
    return [class_labels[c] for c in shared]


def _filter_in_sketches(sketches: List[str], shared_class_names: List[str]) -> List[str]:
    kept = []
    for sketch in sketches:
        _, caption = sketch.split("\t")
        if any(clss in caption for clss in shared_class_names):
            continue
        kept.append(sketch)
    return kept


def add_in_sketches(imagenet_path: str, indices_path: str = "data/indices",
                    class_mapping_path: str = "data/in_to_dn_mapping.json") -> None:
    """ImageNet-Sketch addition mixtures (reference add_in_sketches.py)."""
    for name in [
        "combined-captions-train-lso-real-only",
        "combined-captions-train-lso-cipqr-nosketchclasses",
        "combined-captions-train-lso-cipqrs-nosketchclasses",
    ]:
        samples = _read_tsv_body(os.path.join(indices_path, f"{name}.tsv"))
        captions = [s for s in samples if "captions" in s.split("\t")[0]]
        domainnet = [s for s in samples if "domainnet" in s.split("\t")[0]]
        assert set(samples) == set(captions) | set(domainnet)
        assert not (set(captions) & set(domainnet))

        sketches = _read_tsv_body(os.path.join(imagenet_path, "in-sketch-captions.tsv"))
        shared = _shared_class_names(class_mapping_path)
        non_shared = list(set(XCLIP_IMAGENET_CLASSES) - set(shared))
        assert len(non_shared) == 550
        sketches_filtered = _filter_in_sketches(sketches, shared)

        random.seed(42)
        indices = set(random.sample(range(len(domainnet)), k=len(sketches_filtered)))
        domainnet_filtered = [domainnet[i] for i in range(len(domainnet)) if i not in indices]
        assert len(samples) == len(captions) + len(domainnet_filtered) + len(sketches_filtered)

        out = ["filepath\ttitle\n"] + captions + domainnet_filtered + sketches_filtered
        with open(os.path.join(indices_path, f"{name}-with-in-sketches.tsv"), "w") as fh:
            fh.writelines(out)


def mix_in_sketches(imagenet_path: str, indices_path: str = "data/indices",
                    class_mapping_path: str = "data/in_to_dn_mapping.json") -> None:
    """Sketch replacement/interpolation mixtures (reference
    mix_in_sketches.py): keep {50,30,25,10,5,1}% / one of the DN sketch
    classes, backfill with IN sketches, trim other DN samples to size."""
    name = "combined-captions-train-lso-cipqrs-nosketchclasses"
    samples = _read_tsv_body(os.path.join(indices_path, f"{name}.tsv"))
    captions = [s for s in samples if "captions" in s.split("\t")[0]]
    domainnet = [s for s in samples if "domainnet" in s.split("\t")[0]]
    assert set(samples) == set(captions) | set(domainnet)
    assert not (set(captions) & set(domainnet))

    in_sketches = _read_tsv_body(os.path.join(imagenet_path, "in-sketch-captions.tsv"))
    in_sketches_filtered = _filter_in_sketches(in_sketches, _shared_class_names(class_mapping_path))

    def is_sketch(sample: str) -> bool:
        return "sketch" in sample.split("\t")[0]

    domainnet_sketches = [s for s in domainnet if is_sketch(s)]
    domainnet_other = [s for s in domainnet if not is_sketch(s)]

    sketches_by_class = {}
    for sample in domainnet_sketches:
        *_, domain, clss, path = sample.split("\t")[0].split("/")
        sketches_by_class.setdefault(clss, []).append(sample)

    random.seed(42)
    dn_classes = list(sketches_by_class.keys())
    assert len(dn_classes) == 330
    half = random.sample(dn_classes, k=165)
    quart = random.sample(half, k=82)
    thirtyp = quart + random.sample(list(set(half).difference(quart)), k=17)
    tenp = random.sample(quart, k=33)
    fivep = random.sample(tenp, k=16)
    onep = random.sample(fivep, k=3)
    one = random.sample(onep, k=1)

    for mode, remaining in [
        ("fiftyp", half), ("twentyfivep", quart), ("thirtyp", thirtyp),
        ("tenp", tenp), ("fivep", fivep), ("onep", onep), ("one", one),
    ]:
        dn_remaining: List[str] = []
        for clss in remaining:
            dn_remaining.extend(sketches_by_class[clss])
        removed = len(domainnet_sketches) - len(dn_remaining)
        assert removed <= len(in_sketches_filtered)
        drop = len(in_sketches_filtered) - removed
        indices = set(random.sample(range(len(domainnet_other)), k=drop))
        dn_other_filtered = [domainnet_other[i] for i in range(len(domainnet_other)) if i not in indices]
        assert len(samples) == len(captions) + len(dn_other_filtered) + len(dn_remaining) + len(in_sketches_filtered)
        out = ["filepath\ttitle\n"] + captions + dn_other_filtered + dn_remaining + in_sketches_filtered
        with open(os.path.join(indices_path, f"{name}-with-in-sketches-{mode}.tsv"), "w") as fh:
            fh.writelines(out)
