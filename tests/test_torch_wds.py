"""The port's tar-shard pipeline (``xclip_tpu_torch.data.wds``) and the
trainer's webdataset entry point against the JAX package's.

- ``WebDatasetReader`` at ``num_workers=0``: keys, captions, decoded images
  and their order equal to JAX's, plain, shuffled, with json captions,
  split by rank, resampled and resampled with per-shard weights;
- with worker threads the order is free, the multiset of keys is not; with
  resampling each worker draws its own endless stream (JAX's reader lists
  the endless stream first and never yields);
- a corrupt sample is skipped and logged once (``log_and_continue``), and
  nothing else is dropped;
- ``WdsLoader``'s batches, sizes and its ``--train-num-samples`` refusal;
- ``get_data`` detects ``.tar`` and refuses upsampling without
  resampling, as JAX does;
- the CLI trains a tiny RN for 2 CPU steps from shards (plain, and
  resampled over two ``::`` sources with weights) and writes a checkpoint
  that loads back.
"""

import itertools
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_aux import _build_tar
from test_torch_models import release_memory_after_module  # noqa: F401
from test_torch_train import TINY_TRAIN
from xclip_tpu.data import wds as jax_wds
from xclip_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from xclip_tpu_torch.data import wds
from xclip_tpu_torch.models import factory
from xclip_tpu_torch.tokenizer import get_tokenizer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three shards of six samples: two with ``.json`` captions, one with
    ``.txt``."""
    root = tmp_path_factory.mktemp("shards")
    for s in range(3):
        _build_tar(root / f"s-{s:03d}.tar", 6, prefix=f"k{s}_", start=6 * s, with_json=s < 2)
    return root


def _items(reader, n=40):
    return [(s["__key__"], s["text"], s["image"]) for s in itertools.islice(iter(reader), n)]


def _same(got, want):
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])


READER_CASES = {
    "plain": {},
    "shuffle": {"shuffle": True, "seed": 5, "epoch": 1},
    "json_captions": {"json_caption_key": "caption"},
    "rank_1_of_2": {"rank": 1, "world_size": 2},
    "resampled": {"resampled": True, "seed": 3, "epoch": 2},
    "resampled_weighted": {"resampled": True, "weights": [1.0, 3.0, 0.5], "seed": 1},
}


@pytest.mark.parametrize("case", list(READER_CASES))
def test_reader_matches_jax(shards, case):
    url = str(shards / "s-{000..002}.tar")
    kw = READER_CASES[case]
    got = _items(wds.WebDatasetReader(url, **kw))
    want = _items(jax_wds.WebDatasetReader(url, **kw))
    _same(got, want)
    assert len(got) == (40 if kw.get("resampled") else 6 if "rank" in kw else 18)
    if case == "json_captions":
        assert got[0][1] == "caption 0" and got[-1][1] == "caption 17"


def test_resampled_shards_start_at_epoch_minus_one():
    """``ResampledShards`` increments its epoch in ``__iter__``, so a reader
    at epoch e draws with seed + e, as JAX's does."""
    urls = [f"u{i}.tar" for i in range(5)]
    for kw in ({}, {"weights": [1, 2, 3, 4, 5]}):
        got = wds.ResampledShards(urls, seed=7, epoch=2, **kw)
        want = jax_wds.ResampledShards(urls, seed=7, epoch=2, **kw)
        for _ in range(2):  # a second pass draws for the next epoch
            assert list(itertools.islice(iter(got), 30)) == list(itertools.islice(iter(want), 30))
        assert got.epoch == want.epoch == 4
    assert wds.expand_urls(["a-{00..02}.tar", "b.tar::c.tar"]) == ["a-00.tar", "a-01.tar", "a-02.tar", "b.tar", "c.tar"]
    # JAX expands the braces over the whole string before it splits at "::",
    # so a later source repeats once per brace value (the reference expands
    # each source alone); the port matches JAX
    assert wds.expand_urls("a-{00..01}.tar::b.tar") == jax_wds.expand_urls("a-{00..01}.tar::b.tar") == [
        "a-00.tar", "b.tar", "a-01.tar", "b.tar"]


def test_workers_keep_the_multiset_of_keys(shards):
    url = str(shards / "s-{000..002}.tar")
    want = sorted(s["__key__"] for s in jax_wds.WebDatasetReader(url, num_workers=3))
    for n in (2, 3, 8):
        assert sorted(s["__key__"] for s in wds.WebDatasetReader(url, num_workers=n)) == want
    assert len(want) == 18


def test_resampled_workers_draw_their_own_streams(shards):
    """With resampling and worker threads each worker draws an endless
    stream of its own (seed + worker); the epoch size ends the read, and the
    weights skew the draws. JAX's reader lists the endless shard stream
    before it starts a worker, so it never yields (pinned on its source)."""
    import inspect

    url = str(shards / "s-{000..002}.tar")
    reader = wds.WebDatasetReader(url, resampled=True, weights=[0.0, 0.0, 1.0], num_workers=3, seed=4)
    keys = [s["__key__"] for s in itertools.islice(iter(reader), 60)]
    assert len(keys) == 60 and all(k.startswith("k2_") for k in keys)
    loader = wds.WdsLoader(wds.WebDatasetReader(url, resampled=True, num_workers=2), 4, num_samples=20)
    assert [b["images"].shape[0] for b in loader] == [4] * 5
    assert "shards = list(self._shard_stream())" in inspect.getsource(jax_wds.WebDatasetReader._parallel_iter)
    jax_stream = jax_wds.WebDatasetReader(url, resampled=True, num_workers=2)._shard_stream()
    assert len(list(itertools.islice(jax_stream, 10000))) == 10000


def test_corrupt_sample_is_skipped_and_logged(tmp_path, caplog):
    _build_tar(tmp_path / "c-000.tar", 5, prefix="c", corrupt_one=True)
    _build_tar(tmp_path / "c-001.tar", 5, prefix="c", start=5)
    url = str(tmp_path / "c-{000..001}.tar")
    with caplog.at_level(logging.WARNING):
        got = _items(wds.WebDatasetReader(url))
    warnings = [r for r in caplog.records if "Handling tar-pipeline error" in r.getMessage()]
    assert len(warnings) == 1
    assert [g[0] for g in got] == [f"c{i:06d}" for i in range(1, 10)]
    _same(got, _items(jax_wds.WebDatasetReader(url)))


def test_loader_batches_match_jax(shards):
    url = str(shards / "s-{000..002}.tar")
    got_loader = wds.WdsLoader(wds.WebDatasetReader(url, shuffle=True, seed=2), 4,
                               tokenizer=get_tokenizer("RN50"), num_samples=14)
    want_loader = jax_wds.WdsLoader(jax_wds.WebDatasetReader(url, shuffle=True, seed=2), 4,
                                    tokenizer=jax_get_tokenizer("RN50"), num_samples=14)
    assert (len(got_loader), got_loader.num_samples) == (len(want_loader), want_loader.num_samples) == (3, 12)
    got, want = list(got_loader), list(want_loader)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["texts"], np.asarray(w["texts"]))
    with pytest.raises(ValueError, match="train-num-samples"):
        wds.WdsLoader(wds.WebDatasetReader(url), 4, num_samples=0)


def _args(extra):
    from xclip_tpu_torch.train.params import parse_args

    return parse_args(["--batch-size", "2", "--accum-freq", "2", "--workers", "0", *extra])


def test_get_data_detects_tar_and_refuses_as_jax(tmp_path):
    from xclip_tpu_torch.data.transforms import image_transform
    from xclip_tpu_torch.parallel.distributed import DistInfo
    from xclip_tpu_torch.train.main import get_data

    pre = image_transform(32, is_train=True, seed=0)
    tok, info = get_tokenizer("RN50"), DistInfo.current()
    url = str(tmp_path / "x-{000..001}.tar")
    data = get_data(_args(["--train-data", url, "--train-num-samples", "64"]), pre, pre, tok, False, info)
    assert isinstance(data["train"], wds.WdsLoader)
    assert data["train"].num_batches == 64 // 4 and data["train"].batch_size == 4
    reader = data["train"].reader
    assert (reader.shuffle, reader.resampled, reader.json_caption_key, reader.weights) == (True, False, None, None)
    with pytest.raises(ValueError, match="train-num-samples"):
        get_data(_args(["--train-data", url]), pre, pre, tok, False, info)
    with pytest.raises(ValueError, match="dataset-resampled"):
        get_data(_args(["--train-data", url, "--train-num-samples", "8", "--train-data-upsampling-factors", "1::2"]),
                 pre, pre, tok, False, info)
    data = get_data(_args(["--dataset-type", "webdataset", "--train-data", url, "--train-num-samples", "8",
                           "--dataset-resampled", "--train-data-upsampling-factors", "1::2", "--json-captions"]),
                    pre, pre, tok, False, info)
    reader = data["train"].reader
    assert (reader.resampled, reader.weights, reader.json_caption_key) == (True, [1.0, 2.0], "caption")
    with pytest.raises(ValueError, match="needs --train-data"):
        get_data(_args(["--dataset-type", "webdataset"]), pre, pre, tok, False, info)


@pytest.mark.parametrize("source", ["plain", "resampled_weighted"])
def test_cli_trains_from_shards(tmp_path, monkeypatch, shards, source):
    """2 CPU steps (batch 4 x accum 2) of a tiny RN from tar shards with
    ``--json-captions``: finite logged losses, ``epoch_1.pt`` loads back."""
    from xclip_tpu_torch.core.checkpoint import load_training_checkpoint
    from xclip_tpu_torch.train import main as train_main

    monkeypatch.setitem(factory._MODEL_CONFIGS, "TinyRNwds", TINY_TRAIN)
    data = ["--train-data", str(shards / "s-{000..002}.tar")]
    if source == "resampled_weighted":
        data = ["--dataset-type", "webdataset", "--train-data", f"{shards / 's-000.tar'}::{shards / 's-002.tar'}",
                "--dataset-resampled", "--train-data-upsampling-factors", "1::2"]
    argv = ["--model", "TinyRNwds", *data, "--json-captions", "--train-num-samples", "16", "--batch-size", "4",
            "--accum-freq", "2", "--epochs", "1", "--precision", "fp32", "--warmup", "1", "--lr", "1e-3",
            "--logs", str(tmp_path / "logs"), "--name", "run", "--log-every-n-steps", "1", "--device", "cpu",
            "--workers", "2"]
    assert train_main.main(argv) == 0
    log = (tmp_path / "logs" / "run" / "out.log").read_text()
    lines = [ln for ln in log.splitlines() if "Train Epoch:" in ln]
    assert len(lines) == 2 and "[16/16 (100%)]" in lines[-1]
    assert all(np.isfinite(float(ln.split("Loss: ")[1].split()[0])) for ln in lines)
    ckpt = tmp_path / "logs" / "run" / "checkpoints" / "epoch_1.pt"
    model = factory.create_model("TinyRNwds", device="cpu", seed=1)
    assert load_training_checkpoint(str(ckpt), model) == {"epoch": 1, "name": "run"}
    assert SimpleNamespace(**torch.load(ckpt, map_location="cpu", weights_only=True)).epoch == 1
