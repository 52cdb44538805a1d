"""Fused 1x1-conv matmuls of the ModifiedResNet bottleneck, with autograd.

Counterpart of ``xclip_tpu/ops/fused_conv.py``. A 1x1 conv over NHWC is a
``(M, K) @ (K, C)`` matmul with ``M = N*H*W``.

- :func:`matmul_affine_act` (K1/K2, Pallas ``_affine_act_kernel`` /
  ``_affine_act_id_kernel``): the BatchNorm affine, the residual add and the
  relu ride the matmul's output tiles.
- :func:`matmul_stats` (K3, Pallas ``_matmul_stats_kernel``): ``y = z @ w``
  plus the per-channel ``sum(y)`` and ``sum(y*y)`` of the fp32 accumulator,
  the BatchNorm batch-statistic inputs, in the same pass.

Each launches ``csrc/fused_conv.cu`` for CUDA tensors and uses its plain
version (``*_plain``: fp32 product, one cast) for CPU tensors; nothing else.
The plain versions are also the references the kernels are held against.

:class:`MatmulAffineAct` and :class:`MatmulStats` are the autograd
Functions: forward through the wrappers above, backward in plain PyTorch as
the JAX custom VJPs compute it (``_maa_common_bwd`` and ``_ms_bwd``; the
JAX package has no backward kernel either).

Counters: ``launches`` (K1/K2 kernel launches), ``launches_with_identity``
(the K2 form), ``stats_launches`` (K3), ``affine_act_backward_calls`` and
``stats_backward_calls`` (backward passes of the two Functions, on any
device).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from xclip_tpu_torch.ops import _build

launches = 0
launches_with_identity = 0
stats_launches = 0
affine_act_backward_calls = 0
stats_backward_calls = 0


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


def matmul_stats_plain(z: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, sum(y), sum(y*y))``: fp32 product, column sums over the fp32 y,
    y cast once to z's dtype."""
    y = z.float() @ w.float()
    return y.to(z.dtype), y.sum(dim=0), (y * y).sum(dim=0)


def _check_matmul(z, w, name):
    if z.dim() != 2 or w.dim() != 2 or w.shape[0] != z.shape[1]:
        raise ValueError(f"need z (M, K) and w (K, C); got {tuple(z.shape)} and {tuple(w.shape)}")
    if z.dtype not in _build.DTYPE_CODES or w.dtype != z.dtype:
        raise TypeError(f"z and w must share one of {list(_build.DTYPE_CODES)}; got {z.dtype}, {w.dtype}")
    if w.device != z.device:
        raise ValueError("all inputs must be on one device")
    if not (z.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} needs contiguous inputs")
    if z.shape[0] == 0 or z.shape[1] == 0 or w.shape[1] == 0:
        raise ValueError("empty input")
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {z.device}")


def _check(z, w, g, b, identity):
    _check_matmul(z, w, "matmul_affine_act")
    m, c = z.shape[0], w.shape[1]
    if g.shape != (c,) or b.shape != (c,) or g.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"g and b must be fp32 of shape ({c},)")
    tensors = [g, b]
    if identity is not None:
        if identity.shape != (m, c) or identity.dtype != z.dtype:
            raise ValueError(f"identity must be ({m}, {c}) {z.dtype}; got {tuple(identity.shape)} {identity.dtype}")
        tensors.append(identity)
    if any(t.device != z.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("matmul_affine_act needs contiguous inputs")


def matmul_affine_act(
    z: torch.Tensor,
    w: torch.Tensor,
    g: torch.Tensor,
    b: torch.Tensor,
    identity: Optional[torch.Tensor] = None,
    *,
    relu: bool = True,
) -> torch.Tensor:
    """``[relu]((z @ w) * g + b [+ identity])``, forward only.

    z: (M, K); w: (K, C); g/b: (C,) fp32; identity: (M, C) or None; z, w and
    identity in one of fp32/bf16/fp16. CUDA tensors go through the CUDA
    kernel (or raise); CPU tensors through the plain version.
    """
    global launches, launches_with_identity
    _check(z, w, g, b, identity)
    if z.device.type == "cpu":
        return matmul_affine_act_plain(z, w, g, b, identity, relu=relu)
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


def matmul_stats(z: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, s1, s2)`` with ``y = z @ w`` in z's dtype and fp32 ``s1 =
    sum(y)``, ``s2 = sum(y*y)`` per channel, forward only. The sums run over
    the fp32 accumulator and are the same from run to run (no atomics).
    CUDA tensors go through the CUDA kernel (or raise); CPU tensors through
    the plain version."""
    global stats_launches
    _check_matmul(z, w, "matmul_stats")
    if z.device.type == "cpu":
        return matmul_stats_plain(z, w)
    lib = _build.load_library()
    m, k = z.shape
    c = w.shape[1]
    y = torch.empty((m, c), dtype=z.dtype, device=z.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=z.device)
    # one partial-sum row per output tile of the kernel, whose height the
    # library reports: the kernel writes 2 * tiles * c floats
    tiles = -(-m // lib.xk_matmul_stats_tile_m())
    partial = torch.empty((2, tiles, c), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.xk_matmul_stats(
            _build.DTYPE_CODES[z.dtype], z.data_ptr(), w.data_ptr(), y.data_ptr(), sums[0].data_ptr(),
            sums[1].data_ptr(), partial.data_ptr(), m, k, c, stream)
    if err != 0:
        raise RuntimeError(f"matmul_stats kernel launch failed with CUDA error {err} "
                           f"(M={m}, K={k}, C={c}, {z.dtype})")
    stats_launches += 1
    return y, sums[0], sums[1]


class MatmulAffineAct(torch.autograd.Function):
    """Autograd of :func:`matmul_affine_act` (``_maa_id`` / ``_maa_noid``).

    ``MatmulAffineAct.apply(z, w, g, b, identity, relu)``. The backward is
    ``_maa_common_bwd``: the relu mask from the saved output, ``dz`` and
    ``dw`` as products in z's dtype, and the pre-affine activation
    recomputed as an fp32 product for ``dg``.
    """

    @staticmethod
    def forward(ctx, z, w, g, b, identity, relu):
        out = matmul_affine_act(z, w, g, b, identity, relu=relu)
        ctx.save_for_backward(z, w, g, out)
        ctx.relu = relu
        return out

    @staticmethod
    def backward(ctx, dout):
        global affine_act_backward_calls
        affine_act_backward_calls += 1
        z, w, g, out = ctx.saved_tensors
        dpre = dout.float()
        if ctx.relu:
            dpre = torch.where(out > 0, dpre, 0.0)
        dy = (dpre * g.float()).to(z.dtype)
        need_z, need_w, need_g, need_b, need_id = ctx.needs_input_grad[:5]
        dz = dy @ w.t() if need_z else None
        dw = (z.t() @ dy).to(w.dtype) if need_w else None
        dg = (dpre * (z.float() @ w.float())).sum(dim=0).to(g.dtype) if need_g else None
        db = dpre.sum(dim=0).to(g.dtype) if need_b else None
        did = dpre.to(z.dtype) if need_id else None
        return dz, dw, dg, db, did, None


class MatmulStats(torch.autograd.Function):
    """Autograd of :func:`matmul_stats` (``matmul_stats`` with ``_ms_bwd``):
    ``dtot = dy + ds1 + 2 y ds2`` in fp32 over the saved, rounded y, cast to
    z's dtype; ``dz`` and ``dw`` are products in z's dtype."""

    @staticmethod
    def forward(ctx, z, w):
        y, s1, s2 = matmul_stats(z, w)
        ctx.save_for_backward(z, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        global stats_backward_calls
        stats_backward_calls += 1
        z, w, y = ctx.saved_tensors
        dtot = (dy.float() + ds1.float()[None, :] + 2.0 * y.float() * ds2.float()[None, :]).to(z.dtype)
        dz = dtot @ w.t() if ctx.needs_input_grad[0] else None
        dw = (z.t() @ dtot).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dz, dw
