"""Discover-then-Name concept naming for SAE features.

Counterpart of ``xclip_tpu/sae/naming.py`` (the reference's
``sparse_autoencoder/method.py:140-399`` and ``scripts/name_concepts.py``):
normalize the SAE decoder's dictionary columns, dot them against the CLIP
text embeddings of a vocabulary and name each feature by its argmax
concept. The vocabulary is encoded by the model's text tower on its
device (K4, causal, on the card); the similarity and the argmax are numpy
on the host, as in JAX. Config strings such as
``lr0.0005_l1coeff3e-05_ef8_...`` are parsed by :func:`decode_sae_config`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from xclip_tpu_torch.evals.zero_shot import encode_texts_batched
from xclip_tpu_torch.interp.feature_sharing import sae_concepts


def decode_sae_config(sae_config: str) -> Dict:
    """Parse an SAE run-config string (reference _decode_config:307-329)."""
    out: Dict = {}
    for item in sae_config.split("_"):
        if item.startswith("lr"):
            out["lr"] = float(item[2:])
        elif item.startswith("l1coeff"):
            out["l1_coeff"] = float(item[7:])
        elif item.startswith("ef"):
            out["expansion_factor"] = int(item[2:])
        elif item.startswith("rf"):
            out["resample_freq"] = int(item[2:])
        elif item.startswith("hook"):
            out["hook_points"] = [item[4:]]
        elif item.startswith("bs"):
            out["train_sae_bs"] = int(item[2:])
        elif item.startswith("epo"):
            out["num_epochs"] = int(item[3:])
        else:
            raise ValueError(f"Invalid SAE config item: {item}")
    return out


def embed_vocab(model, tokenizer, concept_names: Sequence[str], batch_size: int = 256) -> np.ndarray:
    """Normalized CLIP text embeddings of a concept vocabulary (reference
    name_concepts.save_activations), in chunks of ``batch_size`` prompts."""
    return encode_texts_batched(model, tokenizer(list(concept_names)), batch_size=batch_size)


def _decoder_np(sae_params: Dict) -> np.ndarray:
    w = sae_params["decoder"]["weight"]
    return (w.detach().cpu().numpy() if torch.is_tensor(w) else np.asarray(w)).astype(np.float32)


def concept_name_similarity_matrix(sae_params: Dict, vocab_embeddings: np.ndarray) -> np.ndarray:
    """(vocab, n_features) similarity: vocab embeddings x unit-norm decoder
    columns (reference get_concept_name_similarity_matrix:221-229)."""
    dic = _decoder_np(sae_params)
    if dic.ndim == 3:  # components axis
        dic = dic[0]
    dic = dic / np.maximum(np.linalg.norm(dic, axis=0, keepdims=True), 1e-12)
    return np.asarray(vocab_embeddings, np.float32) @ dic


class DiscoverThenName:
    """Names every SAE feature by its most similar vocabulary concept."""

    def __init__(self, sae_params: Dict, vocab_embeddings: np.ndarray, vocab_texts: Sequence[str]):
        self.sae_params = sae_params
        self.vocab_embeddings = np.asarray(vocab_embeddings, np.float32)
        self.vocab_texts = list(vocab_texts)

    def get_concept_name_similarity_matrix(self) -> np.ndarray:
        return concept_name_similarity_matrix(self.sae_params, self.vocab_embeddings)

    def get_concept_names(self) -> List[str]:
        top = self.get_concept_name_similarity_matrix().argmax(axis=0)
        return [self.vocab_texts[i] for i in top]

    def get_concepts_from_features(self, x) -> np.ndarray:
        return sae_concepts(self.sae_params, x)

    def write_concept_names_csv(self, path: str) -> List[str]:
        names = self.get_concept_names()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            for idx, name in enumerate(names):
                fh.write(f"{idx},{name}\n")
        return names


def load_concept_names(sae_dir: str) -> List[str]:
    """Read concepts/concept_names.csv (reference analyze_sae_features.py:30-32)."""
    with open(os.path.join(sae_dir, "concepts", "concept_names.csv")) as fh:
        return [line.split(",")[1].strip() for line in fh.readlines()]
