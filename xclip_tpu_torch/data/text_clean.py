"""Small text-cleaning helpers used by the caption exporters.

A copy of ``xclip_tpu/data/text_clean.py``. The reference uses
textacy.preprocessing.remove.html_tags (xclip/datasets.py:1150); this is a
dependency-free equivalent."""

from __future__ import annotations

import html
import re

_TAG_RE = re.compile(r"<[^>]+>")


def remove_html_tags(text: str) -> str:
    return _TAG_RE.sub("", text)


def unescape_html(text: str) -> str:
    return html.unescape(text)


def normalize_whitespace(text: str) -> str:
    return " ".join(text.split())


# textacy.preprocessing.normalize.whitespace equivalents (the reference's
# create_caption_from_sample, scripts/generate_imagenet_captions.py:8,18):
# zero-width spaces removed, linebreak runs -> one "\n", horizontal
# whitespace runs -> one " ", strip. NOTE this differs from
# normalize_whitespace above on newline-adjacent spaces ("a \n b" ->
# "a \n b" here vs "a b" there); the caption pipeline then maps "\n" to a
# space, so the byte output preserves the reference's spacing exactly.
_ZWSP_RE = re.compile("[\u200B\u2060\uFEFF]+")
_LINEBREAK_RE = re.compile(r"((\r\n)|[\r\n\v])+")
_NONBREAKING_SPACE_RE = re.compile(r"[^\S\n\v]+")


def normalize_whitespace_textacy(text: str) -> str:
    text = _ZWSP_RE.sub("", text)
    text = _LINEBREAK_RE.sub("\n", text)
    text = _NONBREAKING_SPACE_RE.sub(" ", text)
    return text.strip()
