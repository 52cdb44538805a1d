"""Synthesize DomainNet captions.

Counterpart of ``scripts/generate_domainnet_captions.py``, with its flags (``data/captions.py``)::

    python -m xclip_tpu_torch.scripts.generate_domainnet_captions --domainnet_path /data/domainnet
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from xclip_tpu_torch.data.captions import generate_domainnet_captions


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Configure DomainNet caption generation.")
    parser.add_argument("--domainnet_path", type=str, help="path to domainnet directory")
    parser.add_argument("--seed", type=int, default=42, help="random seed")
    args = parser.parse_args(argv)
    generate_domainnet_captions(args.domainnet_path, seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
