"""Zero-shot DomainNet-LSO evaluation with top-k accuracies and macro F1.

Counterpart of ``scripts/evaluate_domainnet_lso_openai_topk.py``: the
zero-shot evaluator (``xclip_tpu_torch.evals.run_lso``) with ``--topk``
defaulting to ``1 5 10``::

    python -m xclip_tpu_torch.scripts.evaluate_domainnet_lso_openai_topk --model RN50 \\
        --domain sketch --ckpt_files epoch_1.pt --out_path out/ \\
        --imagenet_path imagenet/ --domainnet_path domainnet/ --precision bf16

``results.json`` then holds ``top-{k}-accuracy`` and ``f1-score`` beside
the accuracies. The device defaults to CUDA (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

from xclip_tpu_torch.evals import run_lso

TOPK = [1, 5, 10]


def main(argv: Optional[Sequence[str]] = None) -> int:
    return run_lso.main(argv, topk_default=TOPK)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    raise SystemExit(main())
