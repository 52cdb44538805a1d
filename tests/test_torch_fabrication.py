"""The port's data fabrication against the JAX package's, byte for byte.

Both packages run in this interpreter on the same synthetic inputs, so the
seeded ``random`` draws and the set-iteration orders they depend on are the
same (the ``-thirtyp`` mixture samples from a list built from a set of
strings: its bytes depend on ``PYTHONHASHSEED``, in JAX as in the
reference). Held equal:

- the DomainNet captions (and the aligned-captions variant and its
  symlinks), the ImageNet-Sketch captions, the ImageNet-Captions TSVs and
  their ``.json`` sidecars;
- every mixture that ``launchers/subsample-domainnet.sh`` builds, its
  commands run through the port's ``subsample_domainnet_lso`` script and
  JAX's, plus ``pseudo_exclude``, ``allow_pct``, the aligned captions and
  the refusals;
- ``merge_ccxm``, ``add_in_sketches`` and every ``mix_in_sketches`` mode on
  ``tests/test_mixture_scripts.py``'s inputs (330 DomainNet sketch
  classes, 550 ImageNet classes not shared with DomainNet);
- ``launchers/train-clip-ccxm.sh``'s command parses in the port's training
  CLI with the values JAX's parser gives.
"""

import json
import os
import random
import runpy
import stat
import subprocess
import sys

import numpy as np
import pytest

from test_mixture_scripts import MAPPING, _in_captions_tree, _mixture_inputs
from test_torch_models import release_memory_after_module  # noqa: F401
from xclip_tpu.data import captions as jax_captions
from xclip_tpu.data import lso as jax_lso
from xclip_tpu.data import mixtures as jax_mixtures
from xclip_tpu.evals.lso import LSO_CLASS_TO_IDX
from xclip_tpu_torch.data import captions, lso, mixtures
from xclip_tpu_torch.scripts import subsample_domainnet_lso as lso_script

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOMAINS = ["clipart", "infograph", "painting", "quickdraw", "real", "sketch"]


def _write_lists(root):
    """DomainNet's ``{domain}_{split}.txt`` lists over 345 classes (the LSO
    classes at their indices), uneven per class, real and quickdraw the
    largest domains."""
    names = [f"thing_{i}" for i in range(345)]
    for cls, idx in LSO_CLASS_TO_IDX.items():
        names[idx] = cls.replace(" ", "_")
    extra = {"real": 2, "quickdraw": 1}
    for d, domain in enumerate(DOMAINS):
        for split in ("train", "test"):
            lines = [f"{domain}/{cls}/img{j}.jpg {ci}\n" for ci, cls in enumerate(names)
                     for j in range(1 + (ci + d) % 3 + extra.get(domain, 0))]
            (root / f"{domain}_{split}.txt").write_text("".join(lines))


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*.tsv"))}


@pytest.fixture(scope="module")
def captioned(tmp_path_factory):
    """One DomainNet tree captioned by JAX (it serves every mixture) and
    one captioned by the port."""
    trees = {}
    for name, gen in (("jax", jax_captions.generate_domainnet_captions),
                      ("port", captions.generate_domainnet_captions)):
        root = tmp_path_factory.mktemp(f"domainnet_{name}")
        _write_lists(root)
        gen(str(root), seed=42)
        trees[name] = root
    return trees


def test_domainnet_captions_byte_identical(captioned):
    jax_files, port_files = _files(captioned["jax"]), _files(captioned["port"])
    assert len(port_files) == 24 and port_files == jax_files
    for domain in DOMAINS:
        link = captioned["port"] / "aligned-captions" / domain
        assert link.is_symlink() and os.readlink(link) == str(captioned["port"] / domain)


def _indices(tmp_path, name):
    ind = tmp_path / name
    ind.mkdir()
    for split in ("train", "val"):
        (ind / f"in-captions-{split}.tsv").write_text(
            "filepath\ttitle\n/data/imagenet/captions/n01/a.jpg\tan imagenet caption\n")
    return ind


def _launcher_commands(tmp_path):
    """The argv of each ``python scripts/subsample_domainnet_lso.py`` call
    that ``launchers/subsample-domainnet.sh`` makes, read from a ``python``
    stub on PATH."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    out = tmp_path / "argv.txt"
    stub = bin_dir / "python"
    stub.write_text(f'#!/bin/bash\nprintf "%s\\n" "$@" >> "{out}"\necho "--END--" >> "{out}"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", DN="DN", IND="IND")
    subprocess.run(["bash", os.path.join(REPO, "launchers", "subsample-domainnet.sh")], cwd=tmp_path, env=env,
                   check=True, capture_output=True, timeout=60)
    commands = [c.strip("\n").split("\n") for c in out.read_text().split("--END--\n") if c.strip()]
    assert all(c[0] == "scripts/subsample_domainnet_lso.py" for c in commands)
    return [c[1:] for c in commands]


def _run_both(argv, dn, jax_ind, port_ind, monkeypatch, capsys):
    """One mixture by JAX's script and by the port's; returns the port's
    printed identifier."""
    sub = {"DN": str(dn)}
    jax_argv = [sub.get(a, str(jax_ind) if a == "IND" else a) for a in argv]
    port_argv = [sub.get(a, str(port_ind) if a == "IND" else a) for a in argv]
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    monkeypatch.setattr(sys, "argv", ["subsample_domainnet_lso.py", *jax_argv])
    runpy.run_path(os.path.join(REPO, "scripts", "subsample_domainnet_lso.py"), run_name="__main__")
    want = capsys.readouterr().out
    assert lso_script.main(port_argv) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith("identifier=")
    return got.split("'")[1]


def test_launcher_mixtures_byte_identical(captioned, tmp_path, monkeypatch, capsys):
    """All 16 mixtures of ``launchers/subsample-domainnet.sh``: equal
    identifiers and equal ``dn-captions-*`` and ``combined-captions-*``
    bytes; the LSO classes are absent from the excluded domain, and each
    subsampled mixture has the size of its single-rendition reference."""
    commands = _launcher_commands(tmp_path)
    assert len(commands) == 16
    jax_ind, port_ind = _indices(tmp_path, "jax"), _indices(tmp_path, "port")
    dn = captioned["jax"]
    lso_names = {c.replace(" ", "_") for c in LSO_CLASS_TO_IDX}
    reference = {}
    for argv in commands:
        ident = _run_both(argv, dn, jax_ind, port_ind, monkeypatch, capsys)
        rows = (port_ind / f"dn-captions-train-{ident}.tsv").read_text().splitlines()[1:]
        if "--exclude" in argv:
            exclude = argv[argv.index("--exclude") + 1]
            assert not any(r.split("\t")[0].split("/")[-3] == exclude and r.split("\t")[0].split("/")[-2] in lso_names
                           for r in rows)
            if "--single_domain" in argv:
                reference[exclude] = len(rows)
            else:
                assert len(rows) == reference[exclude], ident
    assert len(reference) == 5
    assert _files(port_ind) == _files(jax_ind) and len(_files(port_ind)) == 2 + 16 * 4


@pytest.mark.parametrize("argv", [
    ["--exclude", "sketch", "--exclude_domains", "--subsample", "--pseudo_exclude"],
    ["--exclude", "clipart", "--exclude_domains", "--subsample", "--allow_pct", "0.5"],
    ["--exclude", "painting", "--single_domain", "--subsample", "--aligned_captions"],
    ["--exclude", "quickdraw", "--exclude_domains", "infograph"],
], ids=["pseudo_exclude", "allow_pct", "aligned_captions", "nosub"])
def test_lso_modes_byte_identical(captioned, tmp_path, monkeypatch, capsys, argv):
    dn = captioned["jax"] / "aligned-captions" if "--aligned_captions" in argv else captioned["jax"]
    jax_ind, port_ind = _indices(tmp_path, "jax"), _indices(tmp_path, "port")
    ident = _run_both(["--domainnet_path", "DN", "--indices_path", "IND", *argv], dn, jax_ind, port_ind,
                      monkeypatch, capsys)
    assert ident.startswith("lso-") and _files(port_ind) == _files(jax_ind) and len(_files(port_ind)) == 6


def test_lso_refusals_match_jax(captioned, tmp_path):
    """The protocol's assertions: no mode, allow_pct without subsampling,
    an existing mixture without --override."""
    dn, ind = str(captioned["jax"]), str(_indices(tmp_path, "ind"))
    for kwargs in ({}, {"exclude": "sketch", "allow_pct": 0.5}, {"exclude": "real"},
                   {"real_only": True, "subsample": True}):
        with pytest.raises(AssertionError):
            jax_lso.subsample_domainnet_lso(dn, ind, **kwargs)
        with pytest.raises(AssertionError):
            lso.subsample_domainnet_lso(dn, ind, **kwargs)
    assert lso.subsample_domainnet_lso(dn, ind, real_only=True) == "lso-real-only"
    with pytest.raises(AssertionError, match="already exists"):
        lso.subsample_domainnet_lso(dn, ind, real_only=True)


def test_subsample_to_reference_size_matches_jax():
    """The quota and trimming rule on a skewed index, with and without
    allow_pct: the same rows in the same order."""
    rng = random.Random(3)
    samples = [(f"/dn/{d}/c{c}/i{j}.jpg", c, "x") for d in DOMAINS for c in range(40)
               for j in range(rng.randint(1, 9) * (3 if d in ("real", "quickdraw") else 1))]
    cti = {f"c{c}": c for c in range(5)}
    for kw in ({}, {"exclude": "sketch", "allow_pct": 0.3}):
        want = jax_lso.subsample_to_reference_size(samples, DOMAINS, 900, class_to_idx=cti, **kw)
        got = lso.subsample_to_reference_size(samples, DOMAINS, 900, class_to_idx=cti, **kw)
        assert got == want and len(got) == 900


def _sketch_tree(root):
    rng = np.random.RandomState(0)
    for c in range(6):
        folder = root / "sketch" / f"n{c:08d}"
        folder.mkdir(parents=True)
        for j in range(rng.randint(1, 4)):
            (folder / f"s{j}.JPEG").write_bytes(b"\xff\xd8jpg")
    return root


def test_sketch_captions_byte_identical(tmp_path):
    jax_root, port_root = _sketch_tree(tmp_path / "jax"), _sketch_tree(tmp_path / "port")
    jax_captions.generate_sketch_captions(str(jax_root), seed=42)
    captions.generate_sketch_captions(str(port_root), seed=42)
    want = (jax_root / "in-sketch-captions.tsv").read_bytes().replace(str(jax_root).encode(), b"ROOT")
    got = (port_root / "in-sketch-captions.tsv").read_bytes().replace(str(port_root).encode(), b"ROOT")
    assert got == want and got.count(b"\n") > 6


def test_imagenet_captions_and_sidecars_byte_identical(tmp_path):
    """TSVs (the tree's root normalized) and every ``.json`` sidecar; the
    file outside the split is skipped with JAX's warning."""
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for root, gen in ((jax_root, jax_captions.generate_imagenet_captions),
                      (port_root, captions.generate_imagenet_captions)):
        train = _in_captions_tree(root)
        with pytest.warns(UserWarning, match="not in train/val split"):
            gen(str(train), str(root / "captions.json"), str(root / "split.json"), str(root / "out"), seed=42)
    for name in ("in-captions-train.tsv", "in-captions-val.tsv"):
        want = (jax_root / "out" / name).read_bytes().replace(str(jax_root).encode(), b"ROOT")
        got = (port_root / "out" / name).read_bytes().replace(str(port_root).encode(), b"ROOT")
        assert got == want
    sidecars = sorted(p.relative_to(port_root).as_posix() for p in port_root.rglob("train/*/*.json"))
    assert len(sidecars) == 7
    for rel in sidecars:
        assert (port_root / rel).read_bytes() == (jax_root / rel).read_bytes()
        assert "caption" in json.loads((port_root / rel).read_text())


def test_merge_ccxm_byte_identical(tmp_path):
    outs = {}
    for name, fn in (("jax", jax_mixtures.merge_ccxm), ("port", mixtures.merge_ccxm)):
        ind = tmp_path / name
        ind.mkdir()
        (ind / "cc3m-train.tsv").write_text("".join(f"/cc3m/im{i}.jpg\tcc cap {i}.\n" for i in range(10)))
        for ident in mixtures.PAPER_MIXTURES:
            (ind / f"dn-captions-train-{ident}.tsv").write_text(
                "filepath\ttitle\n" + "".join(f"/dn/{ident}/im{i}.jpg\tdn {i}.\n" for i in range(3 + len(ident) % 4)))
        fn("cc3m", str(ind))
        outs[name] = {p.name: p.read_bytes() for p in ind.glob("cc3m-train-*.tsv")}
    assert mixtures.PAPER_MIXTURES == jax_mixtures.PAPER_MIXTURES
    assert len(outs["port"]) == 7 and outs["port"] == outs["jax"]


@pytest.mark.parametrize("fn,n_out", [("add_in_sketches", 3), ("mix_in_sketches", 7)])
def test_sketch_mixtures_byte_identical(tmp_path, fn, n_out):
    outs = {}
    for name, mod in (("jax", jax_mixtures), ("port", mixtures)):
        ind, imagenet = _mixture_inputs(tmp_path / name)
        getattr(mod, fn)(str(imagenet), str(ind), MAPPING)
        outs[name] = {p.name: p.read_bytes() for p in ind.glob("*-with-in-sketches*.tsv")}
    assert len(outs["port"]) == n_out and outs["port"] == outs["jax"]


def test_train_clip_ccxm_launcher_parses(tmp_path):
    """``launchers/train-clip-ccxm.sh``'s command (RN50 at batch 128 x accum
    2 on a cc3m mixture) goes through the port's ``parse_args`` with the
    values JAX's parser gives."""
    from xclip_tpu.train.params import parse_args as jax_parse_args
    from xclip_tpu_torch.train.params import parse_args

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    out = tmp_path / "argv.txt"
    stub = bin_dir / "python"
    stub.write_text(f'#!/bin/bash\nprintf "%s\\n" "$@" > "{out}"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", DATAID="lso-cipqrs-nosketchclasses")
    subprocess.run(["bash", os.path.join(REPO, "launchers", "train-clip-ccxm.sh")], cwd=tmp_path, env=env,
                   check=True, capture_output=True, timeout=60)
    argv = out.read_text().splitlines()
    assert argv[:3] == ["-u", "-m", "xclip_tpu.train.main"]
    args, want = parse_args(argv[3:]), jax_parse_args(argv[3:])
    assert args.train_data == "data/indices/cc3m-train-lso-cipqrs-nosketchclasses.tsv"
    assert (args.batch_size, args.accum_freq, args.warmup, args.report_to) == (128, 2, 2000, "tensorboard")
    for key, val in vars(args).items():
        if hasattr(want, key) and key != "device":
            assert getattr(want, key) == val, key
