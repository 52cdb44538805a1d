"""Paths of the port's data files, kept in ``xclip_tpu_torch/assets/``.

They are byte-identical copies of the JAX package's BPE vocab
(``xclip_tpu/tokenizer``), evaluation metadata (``xclip_tpu/evals``) and
open_clip model configs (``xclip_tpu/models/configs``), so the port reads
nothing under ``xclip_tpu/``. This is the only module that names them.
"""

from __future__ import annotations

from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent.parent
ASSETS = Path(__file__).resolve().parent / "assets"

BPE_VOCAB = ASSETS / "bpe_simple_vocab_16e6.txt.gz"
EVAL_METADATA = ASSETS / "metadata.json"
MODEL_CONFIG_DIR = ASSETS / "model_configs"
