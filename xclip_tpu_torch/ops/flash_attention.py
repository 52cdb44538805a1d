"""Flash attention forward on (B, H, L, D) tensors.

Counterpart of ``xclip_tpu/ops/flash_attention.py`` (Pallas ``_flash_kernel``
via ``flash_attention`` and ``flash_mha``): online softmax with fp32 running
max, sum and accumulator, optional causal mask, IO in q's dtype.

- :func:`flash_attention` launches ``csrc/flash_attention.cu`` for CUDA
  tensors (head dim 64, any length; both products on the tensor cores,
  fp32 as three tf32 products that keep fp32 accuracy) and uses the plain
  version for CPU tensors; nothing else.
- :func:`flash_attention_plain` is the same function in plain PyTorch, fp32
  inside, used by the CPU path and as the kernel's reference.
- :class:`FlashAttention` is its autograd Function: the kernel forward and a
  plain PyTorch backward that recomputes the softmax in fp32 (the JAX
  kernel has no VJP; the JAX train step differentiates the einsum
  ``layers.attention`` instead). A backward kernel is later work.
- ``launches`` counts kernel launches, ``backward_calls`` backward passes.

Like the JAX kernel, Lq must equal Lk, so attnpool's single query uses
``models.layers.attention``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from xclip_tpu_torch.ops import _build

launches = 0
backward_calls = 0

HEAD_DIMS = (64,)  # instantiated in csrc/flash_attention.cu


def flash_attention_plain(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None):
    """Dense softmax attention in fp32, cast once to q's dtype."""
    seq_len, head_dim = q.shape[-2], q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    s = (q.float() * sm_scale) @ k.float().transpose(-1, -2)
    if causal:
        above = torch.ones(seq_len, seq_len, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = False, sm_scale: Optional[float] = None):
    """(B, H, L, D) attention with online softmax; returns (B, H, L, D)."""
    global launches
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, H, L, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_build.DTYPE_CODES)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not {q.device}")
    b, h, seq_len, head_dim = q.shape
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel supports head dims {HEAD_DIMS}; got {head_dim}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if b * h == 0 or seq_len == 0:
        raise ValueError("empty input")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.xk_flash_attention(
            _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, seq_len, head_dim, float(sm_scale), int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err} "
                           f"(B*H={b * h}, L={seq_len}, D={head_dim}, {q.dtype})")
    launches += 1
    return out


class FlashAttention(torch.autograd.Function):
    """``FlashAttention.apply(q, k, v, causal)``: :func:`flash_attention`
    forward; backward in fp32 from P recomputed out of q and k (with the
    causal mask): dV = P^T dO, dP = dO V^T, dS = P (dP - rowsum(dP P)),
    dQ = dS K s, dK = dS^T Q s, each cast to its input's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        global backward_calls
        backward_calls += 1
        q, k, v = ctx.saved_tensors
        seq_len, head_dim = q.shape[-2], q.shape[-1]
        scale = 1.0 / math.sqrt(head_dim)
        qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
        s = (qf * scale) @ kf.transpose(-1, -2)
        if ctx.causal:
            above = torch.ones(seq_len, seq_len, dtype=torch.bool, device=q.device).triu(1)
            s = s.masked_fill(above, float("-inf"))
        p = torch.softmax(s, dim=-1)
        dv = p.transpose(-1, -2) @ do
        dp = do @ vf.transpose(-1, -2)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = (ds @ kf) * scale
        dk = (ds.transpose(-1, -2) @ qf) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def flash_mha(q, k, v, *, num_heads: int, causal: bool = False):
    """(B, L, D) convenience form matching ``models.layers.attention``."""
    b, seq_len, d = q.shape
    hd = d // num_heads

    def split(x):
        return x.reshape(b, seq_len, num_heads, hd).transpose(1, 2).contiguous()

    out = flash_attention(split(q), split(k), split(v), causal=causal)
    return out.transpose(1, 2).reshape(b, seq_len, d)
