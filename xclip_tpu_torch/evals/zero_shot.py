"""Zero-shot classifiers (prompt ensembles -> cosine scores).

Counterpart of ``xclip_tpu/evals/zero_shot.py``: every class prompt is
tokenized on the host into one ``(classes * templates, 77)`` array, encoded
on the device in fixed-size chunks (2048 prompts for the ensemble), then
averaged per class and renormalized. Prediction is one (B, E) x (E, C)
product on the host.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from xclip_tpu_torch.evals import metadata

TEXT_CHUNK = 2048  # prompts per text-tower call


def _l2(x: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    n = np.sqrt(np.sum(x * x, axis=axis, keepdims=True))
    return x / np.maximum(n, eps)


@torch.inference_mode()
def encode_texts_batched(model, token_ids: np.ndarray, *, batch_size: int,
                         dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """Encode a big token array in chunks of ``batch_size`` on the model's
    device -> (N, E) float32 normalized features."""
    device = next(model.parameters()).device
    out = []
    for i in range(0, token_ids.shape[0], batch_size):
        ids = torch.from_numpy(np.ascontiguousarray(token_ids[i : i + batch_size])).to(device)
        out.append(model.encode_text(ids, normalize=True, dtype=dtype).cpu().numpy())
    return np.concatenate(out, axis=0)


class OpenAIZeroShotClassifier:
    """86-template prompt-ensemble classifier: per class, encode all
    templates, L2-normalize, mean over templates, renormalize."""

    def __init__(
        self,
        model,
        tokenizer,
        idx2class: Union[Dict[int, str], List[str]],
        domain_invariant: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        tpls = metadata.XCLIP_OPENAI_TEMPLATES
        if domain_invariant:
            tpls = [t for t in tpls if any(k in t for k in metadata.DOMAIN_TEMPLATE_KEYWORDS)]
        classnames = [idx2class[i] for i in range(len(idx2class))]
        texts = [t.format(c) for c in classnames for t in tpls]
        t0 = time.perf_counter()
        tokens = tokenizer(texts)
        t1 = time.perf_counter()
        feats = encode_texts_batched(model, tokens, batch_size=TEXT_CHUNK, dtype=dtype)
        logging.info("zero-shot head: %d classes x %d templates: tokenize %.2f s, encode %.2f s",
                     len(classnames), len(tpls), t1 - t0, time.perf_counter() - t1)
        feats = feats.reshape(len(classnames), len(tpls), -1)
        self.prompt_feat = _l2(feats.mean(axis=1))  # (C, E)

    def predict_from_features(self, img_feat: np.ndarray, return_scores: bool = False):
        scores = np.asarray(img_feat, dtype=self.prompt_feat.dtype) @ self.prompt_feat.T
        return {"pred": scores if return_scores else scores.argmax(axis=1)}
