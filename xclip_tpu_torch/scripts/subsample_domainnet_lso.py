"""Build one leave-some-out DomainNet mixture.

Counterpart of ``scripts/subsample_domainnet_lso.py``, with its flags (``data/lso.py``)::

    python -m xclip_tpu_torch.scripts.subsample_domainnet_lso --domainnet_path /data/domainnet --indices_path data/indices --exclude sketch --exclude_domains --subsample
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from xclip_tpu_torch.data.lso import subsample_domainnet_lso


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Configure DomainNet subsampling.")
    parser.add_argument("--indices_path", type=str, required=True, help="out path for indices")
    parser.add_argument("--domainnet_path", type=str, required=True)
    parser.add_argument("--exclude", type=str, help="domain to exclude classes from")
    parser.add_argument("--pseudo_exclude", action="store_true")
    parser.add_argument("--single_domain", action="store_true")
    parser.add_argument("--exclude_domains", type=str, nargs="*", default=[])
    parser.add_argument("--subsample", action="store_true")
    parser.add_argument("--allow_pct", type=float, default=0)
    parser.add_argument("--aligned_captions", action="store_true")
    parser.add_argument("--real_only", action="store_true")
    parser.add_argument("--override", action="store_true")
    args = parser.parse_args(argv)
    identifier = subsample_domainnet_lso(
        args.domainnet_path, args.indices_path,
        exclude=args.exclude, pseudo_exclude=args.pseudo_exclude,
        single_domain=args.single_domain, exclude_domains=args.exclude_domains,
        subsample=args.subsample, allow_pct=args.allow_pct,
        aligned_captions=args.aligned_captions, real_only=args.real_only,
        override=args.override,
    )
    print(f"{identifier=}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
