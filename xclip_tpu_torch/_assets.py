"""Paths of the data files the port shares with the JAX package.

These files are read by path and never imported, so the port pulls in no
module of ``xclip_tpu`` (whose package ``__init__`` imports jax). This is
the only module that names them.
"""

from __future__ import annotations

from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
_JAX_PACKAGE = REPO_ROOT / "xclip_tpu"

BPE_VOCAB = _JAX_PACKAGE / "tokenizer" / "bpe_simple_vocab_16e6.txt.gz"
EVAL_METADATA = _JAX_PACKAGE / "evals" / "metadata.json"
MODEL_CONFIG_DIR = _JAX_PACKAGE / "models" / "configs"
