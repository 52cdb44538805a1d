"""CLIP byte-pair-encoding tokenizer (host-side, numpy output).

A copy of ``xclip_tpu/tokenizer/bpe.py`` (itself token-exact with the
OpenAI CLIP BPE), kept here so the port imports nothing of the JAX package.
The merge table is the port's own copy of the JAX package's data file
(``_assets.BPE_VOCAB``). Only what the plain CLIP configs need is copied
(the "lower" cleaning, the two special tokens); the masking tokenizers
(``random_mask_tokenize``, ``simple_mask_tokenize``,
``syntax_mask_tokenize``) are not copied yet.
"""

from __future__ import annotations

import functools
import gzip
import html
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import regex as re

from xclip_tpu_torch._assets import BPE_VOCAB

DEFAULT_CONTEXT_LENGTH = 77

try:  # pragma: no cover - exercised only when ftfy is installed
    import ftfy

    def _fix_text(text: str) -> str:
        return ftfy.fix_text(text)

except ImportError:  # same fallback as the JAX package

    def _fix_text(text: str) -> str:
        return text


@functools.lru_cache()
def byte_to_unicode() -> dict:
    """Reversible byte -> printable-unicode map used by GPT-2-style BPE."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    next_cp = 256
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(next_cp)
            next_cp += 1
    return mapping


def basic_clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split()).strip()


def _clean(text: str) -> str:
    """The plain CLIP configs' "lower" cleaning."""
    return whitespace_clean(basic_clean(text)).lower()


def _adjacent_pairs(word: Sequence[str]) -> set:
    return set(zip(word[:-1], word[1:]))


class SimpleTokenizer:
    """OpenAI-CLIP-compatible BPE tokenizer producing numpy int32 batches."""

    def __init__(self, context_length: int = DEFAULT_CONTEXT_LENGTH):
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(BPE_VOCAB) as fh:
            lines = fh.read().decode("utf-8").split("\n")
        # first line is a version header; the vocab holds 49152-256-2 merges
        merges = [tuple(line.split()) for line in lines[1 : 49152 - 256 - 2 + 1]]

        base = list(self.byte_encoder.values())
        vocab: List[str] = base + [tok + "</w>" for tok in base]
        vocab.extend("".join(m) for m in merges)
        special_tokens = ["<start_of_text>", "<end_of_text>"]
        vocab.extend(special_tokens)

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {tok: tok for tok in special_tokens}

        special_alt = "|".join(special_tokens)
        self.pat = re.compile(
            special_alt + r"""|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )

        self.vocab_size = len(self.encoder)
        self.all_special_ids = [self.encoder[t] for t in special_tokens]
        self.sot_token_id = self.all_special_ids[0]
        self.eot_token_id = self.all_special_ids[1]
        self.context_length = context_length

    def bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: tuple = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _adjacent_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            n = len(word)
            while i < n:
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < n - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _adjacent_pairs(word)

        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text)
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[sub] for sub in self.bpe(token).split(" "))
        return ids

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(
        self,
        texts: Union[str, List[str]],
        context_length: Optional[int] = None,
    ) -> np.ndarray:
        """Tokenize to a ``(len(texts), context_length)`` int32 array:
        ``<sot> tokens <eot>`` padded with zeros; over-length sequences are
        truncated with the final slot forced to ``<eot>``."""
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length

        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token_id
            result[i, : len(tokens)] = tokens
        return result


@functools.lru_cache()
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts: Union[str, List[str]], context_length: int = DEFAULT_CONTEXT_LENGTH) -> np.ndarray:
    return _default_tokenizer()(texts, context_length=context_length)


def get_tokenizer(model_name: str) -> SimpleTokenizer:
    """The CLIP BPE tokenizer with the model config's ``context_length``
    (the config must be one this port builds). A config that names a
    Hugging Face tokenizer (``hf_tokenizer_name``: the SigLIP and CLIPA
    configs) raises: those tokenizers' files are not in the repository."""
    from xclip_tpu_torch.models.factory import get_clip_cfg, get_model_config

    hf_name = (get_model_config(model_name) or {}).get("text_cfg", {}).get("hf_tokenizer_name")
    if hf_name:
        raise NotImplementedError(f"{model_name} uses the Hugging Face tokenizer {hf_name!r}, whose files are "
                                  "not in the repository; only the CLIP BPE tokenizer is available")
    return SimpleTokenizer(context_length=get_clip_cfg(model_name).text.context_length)
