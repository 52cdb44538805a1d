"""Merge CC3M/CC12M train samples with the paper's domain mixtures.

Counterpart of ``scripts/merge_ccxm.py``, with its flags (``data/mixtures.py``)::

    python -m xclip_tpu_torch.scripts.merge_ccxm --mode cc3m --indices_path data/indices
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from xclip_tpu_torch.data.mixtures import merge_ccxm


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Merge CC3M/CC12M train samples with our domain mixtures.")
    parser.add_argument("--mode", type=str, required=True, choices=["cc3m", "cc12m"])
    parser.add_argument("--indices_path", type=str, default="data/indices")
    args = parser.parse_args(argv)
    merge_ccxm(args.mode, args.indices_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
