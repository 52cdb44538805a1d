"""Precision policies: the ``--precision`` flag -> torch dtypes.

Same table as ``xclip_tpu/core/precision.py``: a :class:`Policy` states the
dtype parameters are stored in and the dtype matmul/conv inputs are cast to.
Norm layers always compute in fp32. ``fp16`` keeps the JAX package's
meaning (bf16 compute); IEEE half compute is ``float16``, which the LSO
evaluator selects for ``--precision fp16`` as the JAX evaluator does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32


_POLICIES = {
    "fp32": Policy(),
    "bf16": Policy(compute_dtype=torch.bfloat16),
    "pure_bf16": Policy(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16),
    "amp": Policy(compute_dtype=torch.bfloat16),
    "amp_bf16": Policy(compute_dtype=torch.bfloat16),
    "amp_bfloat16": Policy(compute_dtype=torch.bfloat16),
    "fp16": Policy(compute_dtype=torch.bfloat16),
    "float16": Policy(compute_dtype=torch.float16),
}


def get_policy(precision: Optional[str]) -> Policy:
    if precision is None:
        return _POLICIES["fp32"]
    try:
        return _POLICIES[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}; options: {sorted(_POLICIES)}") from None


def disable_tf32() -> None:
    """fp32 products and convolutions in full fp32 on the card: cuBLAS and
    cuDNN off TF32 for the process (cuDNN's convolutions default to TF32).
    Each entry point's ``main()`` calls it, as the JAX package's fp32 runs
    are full fp32; library functions leave the process's setting alone."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
