"""Synthesize ImageNet-Sketch captions.

Counterpart of ``scripts/generate_sketch_captions.py``, with its flags (``data/captions.py``)::

    python -m xclip_tpu_torch.scripts.generate_sketch_captions --imagenet_path /data/imagenet
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from xclip_tpu_torch.data.captions import generate_sketch_captions


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Configure ImageNet-Sketch caption generation.")
    parser.add_argument("--imagenet_path", type=str, help="path to imagenet directory (containing sketch)")
    parser.add_argument("--seed", type=int, default=42, help="random seed")
    args = parser.parse_args(argv)
    generate_sketch_captions(args.imagenet_path, seed=args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
