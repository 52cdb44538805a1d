"""Evaluation metadata: ImageNet class names and prompt templates.

Read from the port's copy of the JAX package's ``evals/metadata.json``
(``_assets.EVAL_METADATA``) on first access (not at import); see ``xclip_tpu/evals/metadata.py`` for what each
list is.
"""

import functools
import json

from xclip_tpu_torch._assets import EVAL_METADATA

_KEYS = {
    "XCLIP_IMAGENET_CLASSES": "xclip_imagenet_classes",
    "XCLIP_OPENAI_TEMPLATES": "xclip_openai_templates",
}

# template keywords of the domain_invariant filter
DOMAIN_TEMPLATE_KEYWORDS = ["clipart", "infograph", "painting", "quickdraw", "sketch"]


@functools.lru_cache()
def _data() -> dict:
    return json.loads(EVAL_METADATA.read_text())


def __getattr__(name: str):
    if name in _KEYS:
        return list(_data()[_KEYS[name]])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
