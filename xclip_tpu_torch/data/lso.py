"""Leave-some-out (LSO) DomainNet mixtures, the data fabrication of the paper.

A copy of ``xclip_tpu/data/lso.py`` (reference
scripts/subsample_domainnet_lso.py). :func:`subsample_domainnet_lso`
builds one mixture from the captioned DomainNet TSVs: ``real_only``,
``single_domain`` (CG low diversity), all domains (CG high diversity),
``exclude_domains`` (leave-out-domain), ``pseudo_exclude`` (the upper
bound) and ``allow_pct`` (interpolation); with ``subsample`` every mixture
is cut to the single-rendition reference size by per-(domain, class)
ceiling quotas and then trimmed class by class from the largest domains
in ``TRIM_ORDER`` (:func:`subsample_to_reference_size`). It writes
``dn-captions-{train,val}-<identifier>.tsv`` and merges each with
``in-captions-<split>.tsv`` into ``combined-captions-<split>-<identifier>.tsv``;
the identifier is ``lso-<domain initials>-no<domain>classes[...]``
(:func:`build_identifier`).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Set

from xclip_tpu_torch.data.datasets import ALL_DOMAINS, DomainNetCaptions
from xclip_tpu_torch.evals.lso import LSO_CLASS_TO_IDX

TRIM_ORDER = ["real", "quickdraw", "painting", "sketch", "infograph", "clipart"]


def merge_files(split: str, identifier: str, indices_path: str) -> None:
    """Prepend in-captions to the dn mixture -> combined-captions
    (reference :8-22)."""
    in_path = os.path.join(indices_path, f"in-captions-{split}.tsv")
    assert os.path.isfile(in_path), f"Missing in-captions-{split}.tsv"
    with open(in_path) as fh:
        in_captions = fh.readlines()
        assert in_captions[0] == "filepath\ttitle\n"
    with open(os.path.join(indices_path, f"dn-captions-{split}-{identifier}.tsv")) as fh:
        dn_captions = fh.readlines()
        assert dn_captions[0] == "filepath\ttitle\n"
        dn_captions = dn_captions[1:]
    with open(os.path.join(indices_path, f"combined-captions-{split}-{identifier}.tsv"), "w") as fh:
        fh.writelines(in_captions)
        fh.writelines(dn_captions)


def subsample_to_reference_size(
    samples: List, domains: Sequence[str], subsample_size: int,
    *, exclude: Optional[str] = None, allow_pct: float = 0.0,
    class_to_idx: Dict[str, int] = LSO_CLASS_TO_IDX,
) -> List:
    """Per-(domain, class) ceil-quota subsampling then largest-domain
    trimming until the target size is met exactly (reference :112-194)."""
    domain_index: Dict[str, Dict[str, List]] = {d: {} for d in domains}
    for sample in samples:
        path, *_ = sample
        *_, domain, cls, _ = path.split("/")
        cls = cls.replace("_", " ")
        domain_index[domain].setdefault(cls, []).append(sample)
    assert len(samples) == sum(len(s) for d in domains for s in domain_index[d].values())

    shrink = subsample_size / len(samples)
    pseudo_shrink = shrink
    if allow_pct > 0:
        assert exclude is not None
        allowed = sum(
            math.ceil(allow_pct * shrink * len(domain_index[exclude][cls])) for cls in class_to_idx
        )
        maximum = sum(len(domain_index[exclude][cls]) for cls in class_to_idx)
        pseudo_shrink = shrink
        shrink = (subsample_size - allowed) / (len(samples) - maximum)

    sub_index: Dict[str, Dict[str, List]] = {}
    for domain in domains:
        sub_index[domain] = {}
        for cls in domain_index[domain]:
            if allow_pct > 0 and domain == exclude and cls in class_to_idx:
                quota = math.ceil(allow_pct * pseudo_shrink * len(domain_index[domain][cls]))
            else:
                quota = math.ceil(shrink * len(domain_index[domain][cls]))
            sub_index[domain][cls] = domain_index[domain][cls][:quota]

    current = sum(len(s) for d in domains for s in sub_index[d].values())
    assert current >= subsample_size, f"{current=} {subsample_size=}"
    while current != subsample_size:
        for domain in TRIM_ORDER:
            if domain not in sub_index:
                continue
            for cls in sub_index[domain]:
                if allow_pct > 0 and domain == exclude and cls in class_to_idx:
                    continue
                sub_index[domain][cls].pop()
                current -= 1
                if current == subsample_size:
                    break
            if current == subsample_size:
                break

    return [s for d in domains for cls in sub_index[d] for s in sub_index[d][cls]]


def build_identifier(
    *, real_only: bool, domains: Sequence[str], exclude_domains: Sequence[str],
    exclude: Optional[str], subsample: bool, pseudo_exclude: bool,
    allow_pct: float, aligned_captions: bool,
) -> str:
    if real_only:
        identifier = "real-only"
    else:
        identifier = "".join(d[0] for d in domains if d not in exclude_domains) + f"-no{exclude}classes"
        if not subsample:
            identifier += "-nosub"
        if pseudo_exclude:
            identifier += "-pseudo"
        if allow_pct > 0:
            identifier += f"-allow{allow_pct}"
        if aligned_captions:
            identifier += "-aligned"
    return f"lso-{identifier}"


def subsample_domainnet_lso(
    domainnet_path: str,
    indices_path: str,
    *,
    exclude: Optional[str] = None,
    pseudo_exclude: bool = False,
    single_domain: bool = False,
    exclude_domains: Optional[List[str]] = None,
    subsample: bool = False,
    allow_pct: float = 0.0,
    aligned_captions: bool = False,
    real_only: bool = False,
    override: bool = False,
    class_to_idx: Dict[str, int] = LSO_CLASS_TO_IDX,
) -> str:
    """Full mixture-building protocol; returns the mixture identifier."""
    indices_path = os.path.abspath(indices_path)
    domainnet_path = os.path.abspath(domainnet_path)
    exclude_domains = list(exclude_domains or [])

    assert exclude is not None or real_only, "Must specify either exclude or real_only"
    assert allow_pct == 0 or subsample, "allow_pct requires subsampling"
    assert not pseudo_exclude or allow_pct == 0, "Cannot use pseudo_exclude with allow_pct"
    assert "aligned-captions" not in domainnet_path or aligned_captions

    if real_only:
        assert exclude_domains == [] and exclude is None and not pseudo_exclude
        assert not single_domain and not subsample
        exclude_domains = [d for d in ALL_DOMAINS if d != "real"]
        filter_classes: Dict[str, Set[int]] = {}
    else:
        assert exclude in ("clipart", "infograph", "painting", "quickdraw", "sketch")
        filter_classes = (
            {exclude: set(class_to_idx.values())} if not pseudo_exclude and allow_pct == 0 else {}
        )
        if single_domain:
            assert exclude_domains == []
            exclude_domains = [d for d in ALL_DOMAINS if d != exclude and d != "real"]
        else:
            assert "real" not in exclude_domains
            assert all(d in ALL_DOMAINS for d in exclude_domains)

    identity = lambda x: x
    dataset_train = DomainNetCaptions(
        domainnet_path, "train", identity, exclude_domains=exclude_domains, filter_classes=filter_classes
    )
    dataset_val = DomainNetCaptions(
        domainnet_path, "val", identity, exclude_domains=exclude_domains, filter_classes=filter_classes
    )

    # sanity check of the fixed LSO class indices (reference :103-110)
    domainnet_classes = {}
    for path, label, _ in dataset_val.samples:
        *_, clss, _ = path.split("/")
        domainnet_classes[label] = clss.replace("_", " ")
    for cls, label in class_to_idx.items():
        assert domainnet_classes[label] == cls

    if subsample and not real_only:
        reference = DomainNetCaptions(
            domainnet_path, "train", identity,
            exclude_domains=[d for d in ALL_DOMAINS if d != exclude and d != "real"],
            filter_classes={exclude: set(class_to_idx.values())},
        )
        dataset_train.samples = subsample_to_reference_size(
            dataset_train.samples, ALL_DOMAINS, len(reference),
            exclude=exclude, allow_pct=allow_pct, class_to_idx=class_to_idx,
        )

    identifier = build_identifier(
        real_only=real_only, domains=ALL_DOMAINS, exclude_domains=exclude_domains,
        exclude=exclude, subsample=subsample, pseudo_exclude=pseudo_exclude,
        allow_pct=allow_pct, aligned_captions=aligned_captions,
    )

    if not override:
        for split in ("train", "val"):
            for prefix in ("dn-captions", "combined-captions"):
                path = os.path.join(indices_path, f"{prefix}-{split}-{identifier}.tsv")
                assert not os.path.isfile(path), f"{path} already exists"

    dataset_train.to_tsv(os.path.join(indices_path, f"dn-captions-train-{identifier}.tsv"))
    dataset_val.to_tsv(os.path.join(indices_path, f"dn-captions-val-{identifier}.tsv"))
    merge_files("train", identifier, indices_path)
    merge_files("val", identifier, indices_path)
    return identifier
