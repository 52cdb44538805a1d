"""Add ImageNet-Sketch captions to three paper mixtures at equal size.

Counterpart of ``scripts/add_in_sketches.py``, with its flags (``data/mixtures.py``)::

    python -m xclip_tpu_torch.scripts.add_in_sketches --imagenet_path /data/imagenet --indices_path data/indices
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from xclip_tpu_torch.data.mixtures import add_in_sketches


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser("Configure Imagenet-Sketch integration.")
    parser.add_argument("--imagenet_path", type=str, required=True)
    parser.add_argument("--indices_path", type=str, default="data/indices")
    parser.add_argument("--class_mapping_path", type=str, default="data/in_to_dn_mapping.json")
    args = parser.parse_args(argv)
    add_in_sketches(args.imagenet_path, args.indices_path, args.class_mapping_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
