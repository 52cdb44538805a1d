"""ImageNet-Captions JSON to the train/val TSVs and the .json sidecars.

Counterpart of ``scripts/generate_imagenet_captions.py``, with its flags (``data/captions.py``)::

    python -m xclip_tpu_torch.scripts.generate_imagenet_captions --imagenet_train_path /data/imagenet/train
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from xclip_tpu_torch.data.captions import generate_imagenet_captions


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Configure ImageNet caption generation.")
    parser.add_argument("--imagenet_train_path", type=str, help="path to imagenet train directory")
    parser.add_argument("--imagenet_captions_path", type=str, default="data/imagenet_captions.json")
    parser.add_argument("--imagenet_captions_split_path", type=str,
                        default="data/imagenet_captions_train_val_split.json")
    parser.add_argument("--out_path", type=str, default="data/indices")
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)
    generate_imagenet_captions(
        args.imagenet_train_path, args.imagenet_captions_path,
        args.imagenet_captions_split_path, args.out_path, seed=args.seed,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
