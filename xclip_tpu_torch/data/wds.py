"""Tar-shard streaming for training (the webdataset path).

A copy of ``xclip_tpu/data/wds.py`` (reference deps/open_clip/src/training/
data.py:180-510) on stdlib ``tarfile``, without the webdataset package:
brace (``{000..009}``) and ``::`` shard expansion, tar expansion that groups
entries by key and swallows corrupt shards and samples through
``log_and_continue`` (logged, then skipped), a deterministic buffered
shuffle (seed + epoch), shard resampling with replacement and per-source
weights (``ResampledShards``), shards split by rank, the ``--json-captions``
stage (the ``caption`` key of each ``.json`` sidecar) and the epoch size
from ``--train-num-samples``. ``WebDatasetReader`` yields dict samples
(decoded image + caption); ``num_workers`` threads each run the pipeline
over a round-robin share of the shards, so their order across workers is
not deterministic (``num_workers=0`` is); with resampled shards each worker
draws its own stream, where JAX's reader lists the endless stream first
and never yields. ``WdsLoader`` batches them for ``train/main.py``.
"""

from __future__ import annotations

import io
import itertools
import math
import json
import logging
import random
import re
import tarfile
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

_SHARD_SHUFFLE_SIZE = 2000
_SHARD_SHUFFLE_INITIAL = 500
_SAMPLE_SHUFFLE_SIZE = 5000
_SAMPLE_SHUFFLE_INITIAL = 1000

IMAGE_SUFFIXES = ("png", "jpg", "jpeg", "webp")
CAPTION_SUFFIXES = ("txt", "json")


def expand_urls(urls: Union[str, Sequence[str]]) -> List[str]:
    """Brace-notation shard expansion: 'shards-{000..009}.tar' -> 10 urls
    (webdataset contract; reference data.py:83-98 uses braceexpand)."""
    if not isinstance(urls, str):
        out: List[str] = []
        for u in urls:
            out.extend(expand_urls(u))
        return out
    match = re.search(r"\{(\d+)\.\.(\d+)\}", urls)
    if not match:
        return urls.split("::") if "::" in urls else [urls]
    lo, hi = match.group(1), match.group(2)
    width = len(lo)
    expanded = []
    for i in range(int(lo), int(hi) + 1):
        expanded.extend(expand_urls(urls[: match.start()] + f"{i:0{width}d}" + urls[match.end():]))
    return expanded


def log_and_continue(exn: Exception) -> bool:
    logging.warning(f"Handling tar-pipeline error ({exn!r}). Ignoring.")
    return True


def base_plus_ext(path: str):
    match = re.match(r"^((?:.*/|)[^.]+)[.]([^/]*)$", path)
    if not match:
        return None, None
    return match.group(1), match.group(2)


def _valid_sample(sample: Optional[Dict]) -> bool:
    return bool(sample) and "__key__" in sample and len(sample.keys()) > 2


def tar_file_expander(urls: Iterable[str], handler: Callable = log_and_continue) -> Iterator[Dict]:
    """Stream (fname, bytes) entries out of tar shards, swallowing corrupt
    shards/files (reference tarfile_to_samples_nothrow)."""
    for url in urls:
        try:
            with tarfile.open(url) as tf:
                for member in tf:
                    if not member.isfile():
                        continue
                    try:
                        data = tf.extractfile(member).read()
                    except Exception as exn:  # corrupt member
                        if handler(exn):
                            continue
                        raise
                    yield {"fname": member.name, "data": data, "__url__": url}
        except Exception as exn:  # corrupt shard
            if not handler(exn):
                raise


def group_by_keys_nothrow(files: Iterable[Dict], lcase: bool = True) -> Iterator[Dict]:
    current: Optional[Dict] = None
    for filesample in files:
        prefix, suffix = base_plus_ext(filesample["fname"])
        if prefix is None:
            continue
        if lcase:
            suffix = suffix.lower()
        if current is None or prefix != current["__key__"] or suffix in current:
            if _valid_sample(current):
                yield current
            current = {"__key__": prefix, "__url__": filesample["__url__"]}
        current[suffix] = filesample["data"]
    if _valid_sample(current):
        yield current


def filter_no_caption_or_no_image(sample: Dict) -> bool:
    has_caption = any(s in sample for s in CAPTION_SUFFIXES)
    has_image = any(s in sample for s in IMAGE_SUFFIXES)
    return has_caption and has_image


def buffered_shuffle(src: Iterator, bufsize: int, initial: int, rng: random.Random) -> Iterator:
    """Reservoir-style buffered shuffle (webdataset _shuffle semantics)."""
    buf: List = []
    for sample in src:
        buf.append(sample)
        if len(buf) < bufsize:
            if len(buf) >= initial:
                idx = rng.randint(0, len(buf) - 1)
                buf[idx], buf[-1] = buf[-1], buf[idx]
                yield buf.pop()
            continue
        idx = rng.randint(0, len(buf) - 1)
        buf[idx], buf[-1] = buf[-1], buf[idx]
        yield buf.pop()
    rng.shuffle(buf)
    yield from buf


class ResampledShards:
    """Sample shard urls with replacement, optionally weighted
    (reference ResampledShards2, data.py:294-340)."""

    def __init__(self, urls, weights=None, deterministic: bool = True, seed: int = 0, epoch: int = -1):
        self.urls = expand_urls(urls)
        if weights is not None:
            weights = list(weights)
            assert len(weights) == len(self.urls)
        self.weights = weights
        self.deterministic = deterministic
        self.seed = seed
        self.epoch = epoch

    def __iter__(self) -> Iterator[str]:
        self.epoch += 1
        rng = random.Random()
        if self.deterministic:
            rng.seed(self.seed + self.epoch)
        while True:
            if self.weights is None:
                yield rng.choice(self.urls)
            else:
                yield rng.choices(self.urls, weights=self.weights, k=1)[0]


class WebDatasetReader:
    """Iterable over decoded (image, caption) samples from tar shards.

    Mirrors the reference pipeline order: shard list (optionally resampled /
    detshuffled) -> split by worker -> tar expansion -> group by key ->
    filter -> sample shuffle -> decode -> json-caption unpack.
    """

    def __init__(
        self,
        urls: Union[str, Sequence[str]],
        *,
        transform: Optional[Callable] = None,
        resampled: bool = False,
        weights: Optional[Sequence[float]] = None,
        shuffle: bool = False,
        seed: int = 0,
        epoch: int = 0,
        json_caption_key: Optional[str] = None,
        rank: int = 0,
        world_size: int = 1,
        handler: Callable = log_and_continue,
        num_workers: int = 0,
        prefetch: int = 256,
    ):
        self.urls = expand_urls(urls)
        self.transform = transform
        self.resampled = resampled
        self.weights = list(weights) if weights is not None else None
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = epoch
        self.json_caption_key = json_caption_key
        self.rank = rank
        self.world_size = world_size
        self.handler = handler
        self.num_workers = num_workers
        self.prefetch = prefetch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _shard_stream(self) -> Iterator[str]:
        if self.resampled:
            yield from ResampledShards(
                self.urls, weights=self.weights, seed=self.seed, epoch=self.epoch - 1
            )
            return
        shards = list(self.urls)[self.rank :: self.world_size]
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch)
            yield from buffered_shuffle(iter(shards), _SHARD_SHUFFLE_SIZE, _SHARD_SHUFFLE_INITIAL, rng)
        else:
            yield from shards

    def _decode(self, sample: Dict) -> Optional[Dict]:
        from PIL import Image

        img_suffix = next((s for s in IMAGE_SUFFIXES if s in sample), None)
        try:
            img = Image.open(io.BytesIO(sample[img_suffix])).convert("RGB")
        except Exception as exn:
            if self.handler(exn):
                return None
            raise
        image = self.transform(img) if self.transform else np.asarray(img)
        if self.json_caption_key and "json" in sample:
            meta = json.loads(sample["json"])
            caption = meta[self.json_caption_key]
        elif "txt" in sample:
            caption = sample["txt"].decode("utf-8")
        else:
            meta = json.loads(sample["json"])
            caption = meta.get("caption", meta.get("txt", ""))
        return {"image": image, "text": caption, "__key__": sample["__key__"]}

    def _pipeline(self, shards: Iterator[str], shuffle_salt: int = 0) -> Iterator[Dict]:
        files = tar_file_expander(shards, handler=self.handler)
        samples = group_by_keys_nothrow(files)
        samples = filter(filter_no_caption_or_no_image, samples)
        if self.shuffle:
            rng = random.Random(self.seed + self.epoch + 1 + shuffle_salt)
            samples = buffered_shuffle(samples, _SAMPLE_SHUFFLE_SIZE, _SAMPLE_SHUFFLE_INITIAL, rng)
        for sample in samples:
            decoded = self._decode(sample)
            if decoded is not None:
                yield decoded

    def __iter__(self) -> Iterator[Dict]:
        if self.num_workers <= 0:
            yield from self._pipeline(self._shard_stream())
            return
        yield from self._parallel_iter()

    def _parallel_iter(self) -> Iterator[Dict]:
        """Multi-shard parallel read: each worker thread drives the full
        expand->group->decode pipeline over a disjoint round-robin shard
        slice (the reference's torch-DataLoader num_workers split,
        deps/open_clip/src/training/data.py worker sharding), merging into
        a bounded queue. Sample order is nondeterministic across workers,
        like the reference; use num_workers=0 for deterministic order.

        Resampled shards are an endless stream: each worker draws its own
        (``ResampledShards`` seeded with ``seed + worker``, as the
        reference seeds a stream per worker), and the consumer's epoch size
        ends the read. JAX lists the stream first, which never ends."""
        import queue
        import threading

        if self.resampled:
            n = self.num_workers
            streams = [iter(ResampledShards(self.urls, weights=self.weights, seed=self.seed + w,
                                            epoch=self.epoch - 1)) for w in range(n)]
        else:
            shards = list(self._shard_stream())
            n = min(self.num_workers, max(len(shards), 1))
            streams = [iter(shards[w::n]) for w in range(n)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _DONE = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work(wid: int) -> None:
            try:
                for sample in self._pipeline(streams[wid], shuffle_salt=wid):
                    if not put(sample):
                        return
            finally:
                put(_DONE)

        threads = [threading.Thread(target=work, args=(w,), daemon=True) for w in range(n)]
        for t in threads:
            t.start()
        try:
            live = n
            while live:
                item = q.get()
                if item is _DONE:
                    live -= 1
                    continue
                yield item
            for t in threads:
                t.join()
        finally:
            # consumer exited early (e.g. epoch_size slice): unblock workers
            stop.set()

    def batched(self, batch_size: int, *, tokenizer=None, epoch_size: Optional[int] = None) -> Iterator[Dict]:
        """Fixed-size (images, texts) batches; ``epoch_size`` truncates an
        infinite resampled stream (reference epoch equalization)."""
        it = iter(self)
        if epoch_size:
            it = itertools.islice(it, epoch_size)
        while True:
            chunk = list(itertools.islice(it, batch_size))
            if len(chunk) < batch_size:
                return
            images = np.stack([c["image"] for c in chunk])
            texts = [c["text"] for c in chunk]
            if tokenizer is not None:
                texts = tokenizer(texts)
            yield {"images": images, "texts": texts}


class WdsLoader:
    """DataLoader-interface adapter over :class:`WebDatasetReader` for the
    training session (reference get_wds_dataset, deps/open_clip/src/training/
    data.py:309-412: webdataset pipeline + num_samples bookkeeping from
    --train-num-samples). Exposes set_epoch / num_batches / num_samples and
    yields {"images", "texts"} batches like the map-style DataLoader."""

    def __init__(
        self,
        reader: WebDatasetReader,
        batch_size: int,
        *,
        tokenizer=None,
        num_samples: int,
        drop_last: bool = True,
    ):
        if num_samples <= 0:
            raise ValueError(
                "webdataset requires the number of train samples "
                "(--train-num-samples), like the reference"
            )
        self.reader = reader
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self._num_samples = num_samples
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        self.reader.set_epoch(epoch)

    @property
    def num_batches(self) -> int:
        if self.drop_last:
            return self._num_samples // self.batch_size
        return math.ceil(self._num_samples / self.batch_size)

    @property
    def num_samples(self) -> int:
        return self.num_batches * self.batch_size if self.drop_last else self._num_samples

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[Dict]:
        yield from itertools.islice(
            self.reader.batched(self.batch_size, tokenizer=self.tokenizer,
                                epoch_size=self._num_samples),
            self.num_batches,
        )
