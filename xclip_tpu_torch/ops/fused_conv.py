"""Fused 1x1 conv + folded BatchNorm (+ residual) (+ ReLU), forward.

Counterpart of ``xclip_tpu/ops/fused_conv.py:matmul_affine_act`` (Pallas
kernels ``_affine_act_kernel`` / ``_affine_act_id_kernel``). A 1x1 conv over
NHWC is a ``(M, K) @ (K, C)`` matmul with ``M = N*H*W``; the BatchNorm
affine, the residual add and the relu ride the matmul's output tiles.

- :func:`matmul_affine_act` launches ``csrc/fused_conv.cu`` for CUDA
  tensors and uses the plain version for CPU tensors; nothing else.
- :func:`matmul_affine_act_plain` is the same function in plain PyTorch
  (fp32 product and epilogue, one cast), used by the CPU path and as the
  reference the kernel is held against.
- ``launches`` counts kernel launches, ``launches_with_identity`` those
  with a residual (the K2 form).

Forward only: the backward and the BN-statistics kernel (``matmul_stats``)
come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from xclip_tpu_torch.ops import _build

launches = 0
launches_with_identity = 0


def matmul_affine_act_plain(
    z: torch.Tensor,
    w: torch.Tensor,
    g: torch.Tensor,
    b: torch.Tensor,
    identity: Optional[torch.Tensor] = None,
    *,
    relu: bool = True,
) -> torch.Tensor:
    """``[relu]((z @ w) * g + b [+ identity])`` in fp32, cast once to z's dtype."""
    y = (z.float() @ w.float()) * g.float() + b.float()
    if identity is not None:
        y = y + identity.float()
    if relu:
        y = torch.relu(y)
    return y.to(z.dtype)


def _check(z, w, g, b, identity):
    if z.dim() != 2 or w.dim() != 2 or w.shape[0] != z.shape[1]:
        raise ValueError(f"need z (M, K) and w (K, C); got {tuple(z.shape)} and {tuple(w.shape)}")
    m, c = z.shape[0], w.shape[1]
    if z.dtype not in _build.DTYPE_CODES or w.dtype != z.dtype:
        raise TypeError(f"z and w must share one of {list(_build.DTYPE_CODES)}; got {z.dtype}, {w.dtype}")
    if g.shape != (c,) or b.shape != (c,) or g.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"g and b must be fp32 of shape ({c},)")
    tensors = [z, w, g, b]
    if identity is not None:
        if identity.shape != (m, c) or identity.dtype != z.dtype:
            raise ValueError(f"identity must be ({m}, {c}) {z.dtype}; got {tuple(identity.shape)} {identity.dtype}")
        tensors.append(identity)
    if any(t.device != z.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("matmul_affine_act needs contiguous inputs")
    if m == 0 or z.shape[1] == 0 or c == 0:
        raise ValueError("empty input")


def matmul_affine_act(
    z: torch.Tensor,
    w: torch.Tensor,
    g: torch.Tensor,
    b: torch.Tensor,
    identity: Optional[torch.Tensor] = None,
    *,
    relu: bool = True,
) -> torch.Tensor:
    """``[relu]((z @ w) * g + b [+ identity])``.

    z: (M, K); w: (K, C); g/b: (C,) fp32; identity: (M, C) or None; z, w and
    identity in one of fp32/bf16/fp16. CUDA tensors go through the CUDA
    kernel (or raise); CPU tensors through the plain version.
    """
    global launches, launches_with_identity
    _check(z, w, g, b, identity)
    if z.device.type == "cpu":
        return matmul_affine_act_plain(z, w, g, b, identity, relu=relu)
    if z.device.type != "cuda":
        raise ValueError(f"matmul_affine_act runs on CUDA or CPU tensors, not {z.device}")
    lib = _build.load_library()
    m, k = z.shape
    c = w.shape[1]
    out = torch.empty((m, c), dtype=z.dtype, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.xk_matmul_affine_act(
            _build.DTYPE_CODES[z.dtype], z.data_ptr(), w.data_ptr(), g.data_ptr(), b.data_ptr(),
            identity.data_ptr() if identity is not None else None, out.data_ptr(),
            m, k, c, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"matmul_affine_act kernel launch failed with CUDA error {err} "
                           f"(M={m}, K={k}, C={c}, {z.dtype})")
    launches += 1
    launches_with_identity += identity is not None
    return out
